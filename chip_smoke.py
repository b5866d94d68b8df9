#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Builds the port's CUDA kernels from ``deepcharuco_tpu_torch/csrc`` and runs,
stopping at the first failure with a non-zero exit:

1. the card's name and power limit, and the kernels' build;
2. the decode kernel against its plain version on random logits at
   (256, 30, 40, 65/17), with a dustbin-only frame and duplicate-id ties,
   on ragged grids (31, 37) and (29, 41) at N = 1, 3 and 256, on a
   +0.0/−0.0 confidence tie and on a 135×240 grid (1080p frames): exact,
   and two launches give bit-identical outputs;
3. the fused head + decode kernel against its plain version on the shipped
   detector's folded weights, on the fixture's trunk tiled to 256, on that
   trunk under seeded random noise, and on the trunks of tiled frames with
   ragged grids (31, 37) and (29, 41) at N = 1, 3 and 256 and a 135×240
   grid: at most 0.5% slot and 0.5% coordinate mismatch (the two sum the
   1152-long products in different orders), and two launches give
   bit-identical outputs;
4. the port's ``InferencePipeline.detect`` on the fixture frames, with
   ``fused_head=False`` and ``True``, against the JAX package's bf16
   outputs stored in ``tests/data/torch_port_frames.npz``: at most 2% slot
   and 2% coordinate mismatch, and |Δrefined| ≤ 0.125 px on at least 98%
   of the slots that agree;
5. serving: each pipeline answers 8 requests of 256 unique 240×320 frames,
   every result copied to the host; the kernels' launch counts are read
   from this run;
6. each kernel's device time per call (CUDA events around replays of a
   CUDA graph of 20 calls) and its time back to back from the host, at
   N=256 and N=1, beside its plain version's time and the card's bound
   for the same work, and the device operations (kernels, memsets) that
   one call puts on the card, counted by ``torch.profiler``;
   beside the fused kernel two yardsticks on the same trunk: the unfused
   route (the detector's cuDNN heads, then the decode kernel) and one cuDNN
   3×3 convolution to 512 channels; then the conv epilogue alone at N = 256
   frames (4,096 patches) on the three largest blocks (the detector's
   ``conv1b`` with its pool, RefineNet's ``conv5b`` with its upsample and
   ``convPa``), equal bit for bit to the ATen chain it replaces (bias
   ``add_``, ``batch_norm``, ``relu``, pool or upsample), with its device
   time beside its bytes at 3.35 TB/s and beside the chain's time; its
   launches on the main path are phase 5's; and its entry without
   BatchNorm (``bias_relu``, SuperPoint's blocks) at 128 frames of 480×640
   with C 64, 128 and 256, with and without the pool, equal bit for bit to
   ``bias_relu_plain`` on the card, timed beside its bytes' bound and the
   plain version, with its launches (one a block) read from
   ``MatchPipeline.forward_device`` served by ``pipelined_map``;
7. pose on the fixture: ``detect_with_pose`` (bf16, 24-px hard decode, both
   ``fused_head`` settings) against the JAX package's stored ``full_forward``
   outputs: corners within phase 4's limits, ``ok`` different on at most one
   frame, and on frames where ``ok`` agrees and every valid slot is within
   0.125 px |Δrvec| ≤ 0.02 rad and |Δtvec| ≤ 0.02·|tvec|; and the port's
   ``solve_pnp_batch`` on the stored JAX corners against the stored JAX
   pose: ``ok`` equal, |Δrvec| ≤ 1e-3 rad, |Δtvec| ≤ 1e-3·|tvec|, |Δrms| ≤
   1e-3 px (frames whose stored rms exceeds 10 px hold a wrong-cell corner
   and are logged, not held);
8. variants on the fixture against stored JAX bf16 outputs: the 32-px
   RefineNet with ``hires=2`` and the soft decode on stored 480×640 frames
   (at most 2 of 64 slots differ, |Δrefined| ≤ 0.125 px on ≥ 95% of the
   agreeing slots, pose as in phase 7), ``decode_capacity=4`` and
   ``rn_decode="avg"`` with the fixture's seeded offset branch (phase 4's
   limits);
9. serving the pose path: each pipeline answers 8 requests of 256 unique
   frames through ``detect_with_pose``, and 4 through ``full_forward``, which
   must give identical outputs; then the pose tail alone on one batch's
   corners at 256 and 56 frames, the pose kernel (``solve_pose``) against
   the plain path (``solve_pnp_plain`` on the card): host ms to enqueue, ms
   to finish, launches (``kernels.pnp_launches``: one a ``solve_pose`` call,
   one a request), each path's device ms from a CUDA graph, the kernel's
   bound (:func:`pnp_work`), and its agreement (``ok`` equal on frames of 5
   corners or more; on those fitted within 1 px the float64 fit and the
   reported RMS within 1e-4 px, the projections' gap logged); one
   profiled request for the card's busy share; hi-res requests (scale 2, 64
   frames of 480×640); and the patch gather's time and peak memory at the
   tap's sizes;
10. the geometry decode: ``detect_with_pose`` with ``geom_decode=True`` and
    with ``geom_fill=True``, at the base resolution and with ``hires=2``,
    against the JAX package's stored bf16 outputs, the stored Gumbel tables
    passed in: slots that neither side filled within phase 4's limits (phase
    8's under the tap), ``filled`` equal on ≥ 98% of the slots, pose as in
    phase 7; and its ms per batch of 256 beside the parity decode's;
11. the int8 detector: the shipped artifact through ``load_pipeline``; every
    layer's int32 accumulators on the card (im2col + ``torch._int_mm``)
    equal, bit for bit, to the CPU route's (int32 ``F.conv2d``) on the
    fixture frames, and the share of int8 activations that differ;
    ``detect`` against the JAX int8 pipeline's stored outputs (phase 4's
    limits); ms per batch of 256 for the int8 detector beside the bf16
    one's;
12. multi-stream serving: 256 streams × 8 steps of unique 240×320 frames
    through ``StreamServer``, the same frames as 32 streams × 64 steps
    through ``DeviceQueueServer(chunk=8)`` (the same 256-frame blocks), and
    the same batches through ``pipelined_map``, with and without pose: every
    result equal, bit for bit, to the synchronous call on the same batch
    (two batches are in flight, so an output read after the next batch had
    reused its memory would show here); fps beside the synchronous
    loop's, and the card's idle share under both from ``torch.profiler``
    (the union of the device operations' intervals over their span); one
    launch of B1 or B2, and with pose one of the pose kernel, a launched
    step of each served path, counted per path; the geometry decode served
    against synchronous; and the peak bytes of device memory per input pixel
    of served batches (both paths, with and without pose, at 240×320, and
    480×640), which ``serving.TWO_STAGE_BYTES_PER_PIXEL`` must cover;
13. training: the fixture's stored JAX synthesis draws rendered on the card
    (two detector batches, frame patches, RefineNet patches) against the
    stored JAX renders (labels and visible masks equal; images, patches and
    heatmaps within 1e-3 but for one-level low-light rounding flips on at
    most 1% of the pixels, counted); three float32 Adam steps of the
    detector and of RefineNet from the shipped weights on the stored batches,
    TF32 off, against the stored JAX losses (1e-4 relative) and running
    statistics (1e-3 of each layer's scale), then the same numbers with TF32
    on; ``cli.train --device-synth`` for 40 dispatches of 4 steps at batch 32
    on 240×320 frames (eval every 20, 2 batches): finite scalars, top-k
    checkpoints, the decode kernel launched once per eval batch, a
    checkpoint served by ``InferencePipeline``, a run resumed at the first
    checkpoint within 35% of the uninterrupted run's val_loss;
    ``cli.train_refinenet --device-synth --frame-patches`` for 8 dispatches;
    and steps per second, the step alone, synthesis alone, peak memory (TF32
    off and on), the step by device operation, the idle share, and B1's
    launches in one eval batch counted by ``torch.profiler``;
14. the entry points users run, each kernel's launches counted per entry
    point: ``load_pipeline`` from Lightning ``.ckpt`` files that the port
    wrote from the shipped weights and from a trainer checkpoint directory
    (``detect`` bit-equal to the ``.npz``-loaded pipeline); ``cli.benchmark``'s
    core at batch 256 on 8 unique resident batches (two-stage,
    ``--with-pose``, ``--fused-head`` with agreement ≥ 0.98 and B2 launched,
    ``--breakdown``, 256 streams, 32 streams in chunks of 8, and the hi-res
    tap with pose at batch 64), each beside phase 5's, 9's or 12's figure
    for the same path; ``python -m deepcharuco_tpu_torch.bench`` in its own
    process (one JSON line, a FLOP rate under the card's peak); the cores of
    ``cli.infer`` (rows equal to ``detect``'s, phase 4's limits against
    JAX), ``cli.eval`` (float32 on the stored JAX renders against JAX's
    eval: ``n_target`` equal, counts within 2, mean errors within 0.01 px)
    and ``cli.pose_video`` (equal to ``detect_with_pose``; ``--smooth``
    equal to ``PoseFilter``; ``--ransac`` against the port's RANSAC on the
    CPU on the same subsets, within phase 7's limits);
15. the host data pipeline (numpy and the native core; no cv2 on the card's
    machine): the native core built by g++; ``CharucoDataset`` (native and
    numpy routes), ``RefineNetDataset`` and ``make_background_bank(8)``
    against the JAX package's samples stored in the fixture (``host/...``:
    labels and corners equal, images within a level on 0.1% of pixels
    natively, 2 levels on 1% on the numpy route); ``cli.train`` on the host
    stream and with ``--device-synth --bg-bank 8 --mixed-host-every 3
    --eval-host-batches 2`` at batch 32, ``cli.train_refinenet`` on the host
    stream, ``cli.eval --source host --samples 64`` and ``cli.quantize``:
    finite scalars, the ``val_host_*`` scalars, B1's launches; host
    samples/s of both datasets through ``BatchLoader`` at 1, 2, 4 and the
    config's threads, host-fed training steps/s beside on-card synthesis
    and the mixed diet, the card's idle share under host-fed training, and
    a 64-image bank's build time;
16. camera calibration and the grid viewer, with cv2 made unimportable:
    ``cli.calib_intrinsics.charuco_calibrate`` (32-px RefineNet, ``avg``,
    bf16, batch 16; the network on the card, B1 counted; the solver on the
    host) on the fixture's 10 known-camera views (``calib/...``) against the
    JAX CLI's stored result (the same views used, fx and fy within 0.2%, cx
    and cy within 0.5 px, the mean reprojection error within 0.02 px) and
    the true camera (fx, fy within 1.5%, cx, cy within 4 px), twice (the
    second call warm), and on the low-light set (at least 9 views, fx, fy
    within 1.5%, error under 0.6 px); the CLI itself with ``--charuco`` on
    PNGs the port wrote (its ``camera_params.npz`` within 1e-6 of the
    call's); the chessboard mode on the 5 stored boards and the 10 tilted
    views (found on all, corners within 0.01 px of cv2's stored ones after
    the 11×11 refinement, the tilted views' K within 3e-5 of fx of JAX's);
    ``cli.view`` in its three modes, one page each, read back equal to the
    grid drawn, the predictions page equal to ``detect`` drawn; detection
    ms per view, solver ms, each CLI's wall time and B1's launches by path;
17. several ranks (``parallel.mesh``): at world size 1 under NCCL in this
    process, ``sharded_inference`` of ``two_stage_forward`` and
    ``full_forward`` (both ``fused_head`` settings) on the fixture and on a
    batch of 256 bit-equal to the calls without a mesh, and three
    ``sharded_train_step``s (batch 32, TF32 off, cuDNN deterministic)
    bit-equal to the plain step, with ms per batch and per step beside the
    plain calls; then two ranks sharing the card under gloo: ``cli.train
    --device-synth`` under torchrun on 2×1 and 1×2 meshes against one
    process at the same seed (``NVIDIA_TF32_OVERRIDE=0``; train_loss per
    step within 1e-5 relative, and rank 0's last checkpoint's parameters
    within 0.05 lr of one process's, root mean square), rank 0's checkpoint
    served; and
    ``chip_smoke.py --ranks DIR`` (the rank worker) for gloo's collectives
    on CUDA tensors, sharded inference on both meshes against one card
    (phase 4's limits), steps/s per mesh (two ranks sharing one card, not
    a scaling figure), peak memory per rank, the collectives' profiler
    spans in a step, and B1/B2 launches per rank.

Its last lines are the ``nvidia-smi`` name and power limit, one JSON object
with the kernels' numbers, and ``{"ok": true, "device": {...}}``. Imports
nothing of JAX. Run from anywhere: ``python3 chip_smoke.py``; it runs
``python3 chip_smoke.py --ranks DIR`` under torchrun itself.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
RN32 = os.path.join(ROOT, "artifacts", "refinenet32_devsynth.npz")
INT8 = os.path.join(ROOT, "artifacts", "detector_devsynth_int8.npz")
POSE_KEYS = ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "rms")
N, HC, WC, N_IDS = 256, 30, 40, 16
GRIDS = [(n, hc, wc) for hc, wc in ((31, 37), (29, 41)) for n in (1, 3, 256)]
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12     # H100 SXM dense bf16 tensor-core FLOP/s


class SmokeFailure(Exception):
    pass


B1, B2 = "kernels.b1_launches", "kernels.b2_launches"
EPI, PNP = "kernels.epilogue_launches", "kernels.pnp_launches"


def launch_counts():
    """(B1, B2) launches since :func:`reset_launches`, from the port's
    counters (``profiling``)."""
    from deepcharuco_tpu_torch import profiling

    c = profiling.counters()
    return c.get(B1, 0), c.get(B2, 0)


def pnp_launch_count():
    """Pose kernel launches since :func:`reset_launches`."""
    from deepcharuco_tpu_torch import profiling

    return profiling.counters().get(PNP, 0)


def reset_launches():
    from deepcharuco_tpu_torch import profiling

    profiling.reset(B1, B2, EPI, PNP)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so the host's cost per call (argument checks,
    allocation, the launch itself) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def device_ops(fn):
    """(count, summed device ms) of the device operations (kernels, memsets,
    copies) that one call of ``fn`` puts on the card, as ``torch.profiler``
    sees them; (None, None) where it sees none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        return None, None
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3


def pose_rms64(obj, img, valid, K, dist, rvec, tvec):
    """Each frame's RMS reprojection error over its valid slots at the pose
    (rvec, tvec), in float64 on the inputs' device (``tests/test_torch_cuda.py``
    holds the pose kernel to the plain solver with it too)."""
    import torch

    from deepcharuco_tpu_torch.pnp import project_points

    d = (project_points(obj.double(), rvec.double(), tvec.double(), K.double(), dist.double())
         - torch.where(valid[..., None], img, 0.0).double())
    v = valid.double()
    return ((d * d).sum(-1) * v).sum(-1).div(v.sum(-1).clamp_min(1.0)).sqrt()


PEAK_F32 = 67e12       # H100 SXM float32 FLOP/s without tensor cores


def pnp_work(obj, img, valid, K, dist, iters):
    """(float32 operations, bytes) of one pose solve of ``img`` (M, N, 2):
    the operations ``solve_pnp_plain`` performs on the same inputs on the
    CPU, each non-view ATen call counted as the elements of its largest
    operand or output (twice the multiply-adds for a matrix product); the
    bytes the kernel must read and write (points, mask, board, camera,
    the four outputs)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from deepcharuco_tpu_torch.pnp import solve_pnp_plain

    mm = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default}
    free = ("empty", "zeros", "ones", "full", "fill", "copy", "clone", "_to_copy", "lift",
            "arange", "scalar_tensor", "detach", "alias", "new_", "_local_scalar")

    class Count(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if func in mm:
                a, b = args[0], args[1]
                Count.flops += 2 * a.numel() * b.shape[-1]
            elif not func.is_view and not name.startswith(free):
                sizes = [t.numel() for t in tree_leaves((args, out))
                         if isinstance(t, torch.Tensor)]
                Count.flops += max(sizes, default=0)
            return out

    cpu = [t.cpu() for t in (obj, img, valid, K, dist)]
    with Count():
        solve_pnp_plain(*cpu, iters=iters)
    m, n = img.shape[0], img.shape[1]
    nbytes = (m * n * (2 * 4 + 1) + n * 3 * 4 + (9 + 12) * 4
              + m * (1 + 3 * 4 + 3 * 4 + 4))
    return Count.flops, nbytes


def random_logits(rng):
    loc = rng.normal(size=(N, HC, WC, 65)).astype(np.float32)
    ids = rng.normal(size=(N, HC, WC, N_IDS + 1)).astype(np.float32)
    loc[0, ..., 64] = 10.0                       # frame 0: dustbin everywhere
    # frame 1: five cells claim id 3 with the same confidence → lowest cell wins
    for cell in (901, 77, 640, 300, 1100):
        r, c = divmod(cell, WC)
        ids[1, r, c, 3] = 9.0
        loc[1, r, c, :64] = rng.normal(size=64)
        loc[1, r, c, 64] = -10.0
    # frames 2..: many near-duplicate ids (confidences on a coarse grid)
    ids[2:] = np.round(ids[2:] * 2) / 2
    return loc, ids


def grid_logits(rng, n, hc, wc):
    loc = rng.normal(size=(n, hc, wc, 65)).astype(np.float32)
    ids = (np.round(rng.normal(size=(n, hc, wc, N_IDS + 1)) * 2) / 2).astype(np.float32)
    return loc, ids


def signed_zero_logits():
    """Id 3 claimed with confidence −0.0 by cell 517 and +0.0 by the higher
    cells 902 and 1100 of every frame: the lowest cell must win."""
    loc = np.zeros((3, HC, WC, 65), np.float32)
    loc[..., 64] = -10.0
    loc[..., 5] = 1.0
    ids = np.full((3, HC, WC, N_IDS + 1), -5.0, np.float32)
    for cell, zero in ((517, -0.0), (902, 0.0), (1100, -0.0)):
        r, c = divmod(cell, WC)
        ids[:, r, c, 3] = zero
    return loc, ids


def twice_equal(fn):
    """Two launches of ``fn`` give bit-identical outputs."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_decode(rng, dev):
    import torch

    from deepcharuco_tpu_torch.ops import cuda_decode

    loc_np, ids_np = random_logits(rng)
    cases = [(f"{N}×{HC}×{WC}", loc_np, ids_np)]
    cases += [(f"{n}×{hc}×{wc}", *grid_logits(rng, n, hc, wc)) for n, hc, wc in GRIDS]
    cases += [("±0 tie", *signed_zero_logits()), ("2×135×240", *grid_logits(rng, 2, 135, 240))]
    err = 0.0
    for tag, l_np, i_np in cases:
        loc, ids = torch.from_numpy(l_np).to(dev), torch.from_numpy(i_np).to(dev)
        for mm in (None, 0.5):
            kk, vk = cuda_decode.decode(loc, ids, N_IDS, min_margin=mm)
            kp, vp = cuda_decode.decode_plain(loc, ids, N_IDS, min_margin=mm)
            torch.cuda.synchronize()
            require(torch.equal(vk, vp), f"decode kernel [{tag}]: valid differs (min_margin={mm})")
            require(torch.equal(kk, kp), f"decode kernel [{tag}]: keypoints differ (min_margin={mm})")
            err = max(err, float((kk - kp).abs().max()))
        require(twice_equal(lambda: cuda_decode.decode(loc, ids, N_IDS)),
                f"decode kernel [{tag}]: two launches differ")
        if tag == "±0 tie":
            r, c = divmod(517, WC)
            require(bool(vk[:, 3].all()) and kk[:, 3].tolist() == [[8 * c + 5, 8 * r]] * 3,
                    "decode kernel: ±0 tie not broken to the lowest cell")
        log(f"phase 2 decode kernel [{tag}]: exact (valid {int(vk.sum())}), deterministic")
    loc, ids = torch.from_numpy(loc_np).to(dev), torch.from_numpy(ids_np).to(dev)
    kk, vk = cuda_decode.decode(loc, ids, N_IDS)
    require(not bool(vk[0].any()), "decode kernel: dustbin-only frame has a claim")
    r, c = divmod(77, WC)
    pix = int(np.argmax(loc_np[1, r, c]))
    require(bool(vk[1, 3]) and kk[1, 3].tolist() == [8 * c + pix % 8, 8 * r + pix // 8],
            "decode kernel: tie not broken to the lowest cell")
    log(f"phase 2 decode kernel: dustbin frame empty, tie → lowest cell; max_abs_err {err}")
    return err


def mismatch(kp_a, v_a, kp_b, v_b):
    """(slot mismatch rate, coordinate mismatch rate on slots valid in both)."""
    both = v_a & v_b
    slot = float((v_a != v_b).float().mean())
    coord = float((((kp_a - kp_b).abs().amax(-1) > 0) & both).float().mean())
    return slot, coord


def grid_frames(frames, n, hc, wc):
    """n gray frames of (8·hc, 8·wc) pixels tiled from the fixture frames."""
    h, w = 8 * hc, 8 * wc
    reps = (1, -(-h // frames.shape[1]), -(-w // frames.shape[2]))
    big = np.tile(frames, reps)[:, :h, :w]
    return big[np.arange(n) % len(big)]


def noisy(trunk, rng):
    """A trunk no model gave: scaled elementwise by lognormal noise (a trunk
    of plain random numbers makes the trained heads claim nothing)."""
    import torch

    noise = np.exp(0.3 * rng.normal(size=tuple(trunk.shape))).astype(np.float32)
    return (trunk.float() * torch.from_numpy(noise).to(trunk.device)).to(torch.bfloat16)


def phase_fused(rng, dev, detector, folded, frames):
    import torch

    from deepcharuco_tpu_torch.ops import cuda_fused
    from deepcharuco_tpu_torch.ops.image import normalize_gray

    def trunk_of(f):
        with torch.inference_mode():
            return detector(normalize_gray(torch.from_numpy(f).to(dev)),
                            trunk_only=True)["trunk"]

    trunk_fix = trunk_of(frames).repeat(N // len(frames), 1, 1, 1)
    trunk_rnd = noisy(trunk_fix, rng)
    cases = [("fixture", trunk_fix, None), ("random", trunk_rnd, None),
             ("random,min_margin=2", trunk_rnd, 2.0)]
    cases += [(f"{n}×{hc}×{wc}", noisy(trunk_of(grid_frames(frames, n, hc, wc)), rng), None)
              for n, hc, wc in GRIDS + [(1, 135, 240)]]
    err, rates = 0.0, {}
    for tag, trunk, mm in cases:
        kk, vk = cuda_fused.fused_head_decode(trunk, folded, N_IDS, mm)
        kp, vp = cuda_fused.fused_head_decode_plain(trunk, folded, N_IDS, mm)
        torch.cuda.synchronize()
        slot, coord = mismatch(kk, vk, kp, vp)
        both = vk & vp
        if bool(both.any()):
            err = max(err, float((kk - kp).abs().amax(-1)[both].max()))
        rates[tag] = (slot, coord)
        same = twice_equal(lambda: cuda_fused.fused_head_decode(trunk, folded, N_IDS, mm))
        log(f"phase 3 fused kernel [{tag}]: slot mismatch {slot:.5f}, coord mismatch "
            f"{coord:.5f}, valid {int(vk.sum())}/{vk.numel()}, deterministic {same}")
        require(slot <= 0.005 and coord <= 0.005,
                f"fused kernel [{tag}] disagrees with its plain version: {slot}, {coord}")
        require(same, f"fused kernel [{tag}]: two launches differ")
    return err, rates


def phase_main_path(pipes, fix):
    import torch

    frames = fix["frames"]
    ref_kp, ref_v, ref_r = (torch.from_numpy(fix[f"{k}_bf16"])
                            for k in ("keypoints", "valid", "refined"))
    for name, pipe in pipes.items():
        reset_launches()
        kp, v, r = (torch.from_numpy(a) for a in pipe.detect(frames))
        slot, coord = mismatch(kp, v, ref_kp, ref_v)
        agree = v & ref_v & ((kp - ref_kp).abs().amax(-1) == 0)
        near = float(((r - ref_r).abs().amax(-1) <= 0.125)[agree].float().mean())
        counts = launch_counts()
        log(f"phase 4 main path [{name}] vs JAX bf16: slot mismatch {slot:.4f}, coord "
            f"mismatch {coord:.4f}, |Δrefined|≤0.125 on {near:.4f} of {int(agree.sum())} "
            f"agreeing slots; launches decode/fused {counts}")
        require(slot <= 0.02 and coord <= 0.02, f"[{name}] keypoints disagree with JAX")
        require(near >= 0.98, f"[{name}] refined corners disagree with JAX")
        want = (1, 0) if name == "heads+decode" else (0, 1)
        require(counts == want, f"[{name}] kernel launches {counts}, expected {want}")
        if name == "fused":
            fk, fv = torch.from_numpy(fix["keypoints_fused"]), torch.from_numpy(fix["valid_fused"])
            slot, coord = mismatch(kp, v, fk, fv)
            log(f"phase 4 main path [fused] vs JAX fused kernel: slot {slot:.4f}, coord {coord:.4f}")
            require(slot <= 0.02 and coord <= 0.02, "[fused] disagrees with the JAX fused kernel")


def make_batches(gray, count, rng, n=N):
    out = []
    for tag in range(count):
        src = gray[rng.integers(0, len(gray), size=n)]
        shifts = rng.integers(0, 32, size=n)
        b = np.stack([np.roll(f, int(s) + tag, axis=1) for f, s in zip(src, shifts)])
        noise = rng.integers(-25, 26, size=b.shape, dtype=np.int16)
        out.append(np.clip(b.astype(np.int16) + noise, 0, 255).astype(np.uint8))
    return out


def phase_serve(pipes, frames, rng):
    import torch

    from deepcharuco_tpu_torch import profiling

    requests = 8
    batches = make_batches(frames, requests * len(pipes), rng)
    for pipe in pipes.values():          # warm-up: cuDNN plans, allocator
        pipe.detect(batches[0])
    torch.cuda.synchronize()
    reset_launches()
    serve = {}
    for i, (name, pipe) in enumerate(pipes.items()):
        t0 = time.perf_counter()
        total = 0
        for b in batches[i * requests:(i + 1) * requests]:
            kp, v, r = pipe.detect(b)
            require(kp.shape == (N, N_IDS, 2) and r.shape == (N, N_IDS, 2)
                    and np.isfinite(r).all(), f"[{name}] bad serve output")
            total += int(v.sum())
        dt = time.perf_counter() - t0
        serve[name] = {"fps": N * requests / dt, "ms_per_batch": 1e3 * dt / requests,
                       "valid_per_frame": total / (N * requests)}
        log(f"phase 5 serve [{name}]: {requests} requests × {N} frames: "
            f"{serve[name]['fps']:.1f} fps, {serve[name]['ms_per_batch']:.3f} ms/batch, "
            f"{serve[name]['valid_per_frame']:.2f} corners/frame")
    launches = {"decode": launch_counts()[0], "fused_head_decode": launch_counts()[1],
                "conv_epilogue": profiling.counters().get(EPI, 0)}
    log(f"phase 5 launches on the main path: {launches}")
    require(all(v >= requests for v in launches.values()),
            f"a kernel of the main path was not launched: {launches}")
    return serve, launches, batches[0]


def unfused_heads(det, trunk):
    """The detector's heads (cuDNN) on a trunk: the route B2 replaces."""
    import torch

    from deepcharuco_tpu_torch.models.detector import to_nchw, to_nhwc

    x = to_nchw(trunk)
    loc = det.convPb(det.convPa(x))
    ids = det.convDb(det.convDa(x))
    return to_nhwc(loc.float()), to_nhwc(ids.float())


def phase_timing(dev, pipes, batch, folded, launches, errs):
    import torch
    import torch.nn.functional as F

    from deepcharuco_tpu_torch.models.detector import to_nchw
    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
    from deepcharuco_tpu_torch.ops.image import normalize_gray

    det = pipes["heads+decode"].detector
    with torch.inference_mode():
        g = normalize_gray(torch.from_numpy(batch).to(dev))
        out = det(g)
        trunk = det(g, trunk_only=True)["trunk"]
    m = HC * WC
    w512 = torch.cat([det.convPa.conv.weight, det.convDa.conv.weight]).contiguous(
        memory_format=torch.channels_last)
    b512 = torch.cat([det.convPa.conv.bias, det.convDa.conv.bias])

    def bounds(n):
        out_bytes = n * N_IDS * (2 * 4 + 1)
        dec = (n * m * (65 + N_IDS + 1) * 4 + out_bytes) / PEAK_BYTES, 0.0
        fused_flops = 2 * n * m * (9 * 128 * 512 + 256 * 65 + 256 * (N_IDS + 1))
        fused_bytes = (n * m * 128 * 2 + out_bytes
                       + sum(folded[k].numel() * folded[k].element_size()
                             for k in ("wh", "bpa", "bda", "wpb", "bpb", "wdb", "bdb")))
        return {"decode": dec, "fused_head_decode": (fused_bytes / PEAK_BYTES,
                                                     fused_flops / PEAK_BF16)}

    rows, yard = [], {}
    with torch.inference_mode():
        for n in (N, 1):
            loc, ids, tr = out["loc"][:n].contiguous(), out["ids"][:n].contiguous(), trunk[:n].contiguous()
            x = to_nchw(tr)
            specs = {
                "decode": ("deepcharuco_tpu_torch/csrc/decode.cu",
                           "deepcharuco_tpu/ops/pallas_decode.py:89",
                           lambda: cuda_decode.decode(loc, ids, N_IDS),
                           lambda: cuda_decode.decode_plain(loc, ids, N_IDS)),
                "fused_head_decode": ("deepcharuco_tpu_torch/csrc/fused_head_decode.cu",
                                      "deepcharuco_tpu/ops/pallas_fused.py:162",
                                      lambda: cuda_fused.fused_head_decode(tr, folded, N_IDS),
                                      lambda: cuda_fused.fused_head_decode_plain(tr, folded, N_IDS)),
            }
            for name, (src, rep, kern, plain) in specs.items():
                ms = graph_ms(kern)
                host_ms = cuda_ms(kern)
                plain_ms = cuda_ms(plain, iters=5)
                ms2 = graph_ms(kern)
                t_bytes, t_ops = bounds(n)[name]
                bound_ms = 1e3 * max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                log(f"phase 6 timing [{name}] N={n}: device {ms:.4f} / {ms2:.4f} ms per call "
                    f"(CUDA graph: scratch memset + kernel), {host_ms:.4f} ms per call "
                    f"back to back from the host, plain {plain_ms:.4f} ms, bound "
                    f"{bound_ms:.4f} ms ({by})")
                if n == N:
                    ops = device_ops(kern)[0]
                    log(f"phase 6 [{name}]: {ops} device operations per call (profiler)")
                    rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                                 "launches": launches[name], "max_abs_err": errs[name],
                                 "ms": min(ms, ms2), "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": by, "library_ms": None, "host_ms": host_ms,
                                 "device_launches_per_call": ops})
                else:
                    row = next(r for r in rows if r["name"] == name)
                    row.update({"n1_ms": min(ms, ms2), "n1_host_ms": host_ms,
                                "n1_plain_ms": plain_ms, "n1_bound_ms": bound_ms})
            unfused = graph_ms(lambda: cuda_decode.decode(*unfused_heads(det, tr), N_IDS))
            conv512 = graph_ms(lambda: F.conv2d(x, w512, b512, padding=1))
            yard[f"N={n}"] = {"unfused_route_ms": unfused, "cudnn_conv3x3_512_ms": conv512}
            log(f"phase 6 yardsticks N={n} on the same trunk: unfused route (cuDNN heads + "
                f"decode kernel) {unfused:.4f} ms, cuDNN 3×3 conv to 512 channels "
                f"{conv512:.4f} ms (neither computes B2's whole function)")
    return rows, yard


def phase_epilogue(pipes, launches):
    """The conv epilogue alone on the three largest blocks at N = 256:
    equality with the ATen chain, device ms (CUDA graph) beside the bytes'
    bound and the chain's ms."""
    import torch
    import torch.nn.functional as F

    from deepcharuco_tpu_torch.ops import conv_epilogue

    det, rn = pipes["heads+decode"].detector, pipes["heads+decode"].refinenet
    patches = N * N_IDS
    cases = [("detector.conv1b", det.conv1b, (N, 64, 8 * HC, 8 * WC), "pool"),
             ("refinenet.conv5b", rn.conv5b, (patches, 64, 32, 32), "up"),
             ("refinenet.convPa", rn.convPa, (patches, 64, 64, 64), None)]
    follow = {"pool": lambda y: F.max_pool2d(y, 2, 2),
              "up": lambda y: F.interpolate(y, scale_factor=2, mode="nearest"),
              None: lambda y: y}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    with torch.inference_mode():
        for name, blk, shape, then in cases:
            bn = blk.bn
            args = (blk.conv.bias, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                    bn.eps, then)
            x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
            x = (2 * x).contiguous(memory_format=torch.channels_last)

            def kernel():
                return conv_epilogue.epilogue(x, *args)

            def chain():
                y = x.clone()
                y.add_(blk.conv.bias.view(1, -1, 1, 1))
                y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                 False, 0.0, bn.eps)
                return follow[then](F.relu(y))

            got, want = kernel(), chain()
            same = torch.equal(got, want)
            del got, want
            ms, ms2 = graph_ms(kernel, iters=10), graph_ms(kernel, iters=10)
            host_ms = cuda_ms(kernel)
            clone_ms = graph_ms(lambda: x.clone(), iters=10)
            chain_ms = graph_ms(chain, iters=5) - clone_ms
            out_el = x.numel() // 4 if then == "pool" else 4 * x.numel() if then == "up" \
                else x.numel()
            bound_ms = 1e3 * 2 * (x.numel() + out_el) / PEAK_BYTES
            kms = min(ms, ms2)
            log(f"phase 6 conv epilogue [{name}, then={then}] {tuple(shape)}: equal to the "
                f"chain {same}; device {ms:.4f} / {ms2:.4f} ms, back to back from the host "
                f"{host_ms:.4f} ms; bound {bound_ms:.4f} ms (bytes) = "
                f"{100 * bound_ms / kms:.1f}% of it; ATen chain {chain_ms:.4f} ms "
                f"({chain_ms / kms:.2f}×)")
            require(same, f"conv epilogue [{name}] differs from the ATen chain")
            rows.append({"block": name, "then": then, "shape": list(shape), "ms": kms,
                         "host_ms": host_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                         "chain_ms": chain_ms})
            del x
            torch.cuda.empty_cache()
    return {"name": "conv_epilogue", "route": "cuda",
            "source": "deepcharuco_tpu_torch/csrc/conv_epilogue.cu", "replaces": None,
            "launches": launches["conv_epilogue"], "blocks": rows}


SPLG_CONFIG = os.path.join(ROOT, "portbench", "configs", "splg_480x640.json")
SP_FRAMES = 128
SP_CASES = [("superpoint.conv1a", (SP_FRAMES, 64, 480, 640), None),
            ("superpoint.conv1b", (SP_FRAMES, 64, 480, 640), "pool"),
            ("superpoint.conv3a", (SP_FRAMES, 128, 120, 160), None),
            ("superpoint.conv3b", (SP_FRAMES, 128, 120, 160), "pool"),
            ("superpoint.convPa", (SP_FRAMES, 256, 60, 80), None),
            ("C 256 with a pool", (SP_FRAMES, 256, 60, 80), "pool")]


def phase_epilogue_no_norm(dev):
    """The epilogue's entry without BatchNorm (``conv_epilogue.bias_relu``)
    alone at SuperPoint's shapes, 128 frames of 480×640: equal bit for bit
    to ``bias_relu_plain`` on the card, device ms (CUDA graph) beside the
    bytes' bound and the plain version's ms; then its launches in the main
    path's own run, ``MatchPipeline.forward_device`` under
    ``serving.pipelined_map`` at ``splg_480x640``, one a block."""
    import torch

    from deepcharuco_tpu_torch import profiling
    from deepcharuco_tpu_torch.matching import MatchPipeline
    from deepcharuco_tpu_torch.ops import conv_epilogue
    from deepcharuco_tpu_torch.serving import pipelined_map
    from reference import superpoint_lightglue as splg

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    with torch.inference_mode():
        for name, shape, then in SP_CASES:
            x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
            x = (2 * x).contiguous(memory_format=torch.channels_last)
            bias = (0.5 * torch.randn(shape[1], generator=gen, device="cuda")).to(torch.bfloat16)

            def kernel():
                return conv_epilogue.bias_relu(x, bias, then)

            got, want = kernel(), conv_epilogue.bias_relu_plain(x, bias, then)
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            del got, want
            ms, ms2 = graph_ms(kernel, iters=3), graph_ms(kernel, iters=3)
            plain_ms = cuda_ms(lambda: conv_epilogue.bias_relu_plain(x, bias, then), iters=3,
                               warmup=1)
            out_el = x.numel() // 4 if then == "pool" else x.numel()
            bound_ms = 1e3 * 2 * (x.numel() + out_el) / PEAK_BYTES
            kms = min(ms, ms2)
            log(f"phase 6 conv epilogue, no norm [{name}, then={then}] {tuple(shape)}: bit-equal "
                f"to bias_relu_plain {same}; device {ms:.4f} / {ms2:.4f} ms; bound "
                f"{bound_ms:.4f} ms (bytes) = {100 * bound_ms / kms:.1f}% of it; plain "
                f"{plain_ms:.4f} ms ({plain_ms / kms:.2f}×)")
            require(same, f"conv epilogue without BatchNorm [{name}] differs from its plain "
                          "version")
            rows.append({"block": name, "then": then, "shape": list(shape), "ms": kms,
                         "bound_ms": bound_ms, "bound_by": "bytes", "plain_ms": plain_ms})
            del x
            torch.cuda.empty_cache()
    with open(SPLG_CONFIG) as f:
        conf = json.load(f)
    sp, lg = splg.draw_weights(conf, 1)
    pipe = MatchPipeline(sp, lg, max_num_keypoints=conf["max_num_keypoints"],
                         nms_radius=conf["nms_radius"],
                         detection_threshold=conf["detection_threshold"],
                         remove_borders=conf["remove_borders"],
                         descriptor_dim=conf["descriptor_dim"], n_layers=conf["n_layers"],
                         num_heads=conf["num_heads"], filter_threshold=conf["filter_threshold"],
                         device=dev)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 256, (SP_FRAMES, *conf["input_hw"]), dtype=np.uint8)
               for _ in range(3)]
    profiling.reset(EPI)
    served = sum(1 for _ in pipelined_map(pipe.forward_device, batches, 2, dev))
    launches = profiling.counters().get(EPI, 0)
    log(f"phase 6 conv epilogue, no norm: {launches} launches in {served} batches of "
        f"MatchPipeline.forward_device under pipelined_map")
    require(launches == 10 * served, "SuperPoint's ten blocks do not each launch the "
                                     "epilogue once a batch")
    del pipe
    torch.cuda.empty_cache()
    return {"name": "conv_epilogue (no norm)", "route": "cuda",
            "source": "deepcharuco_tpu_torch/csrc/conv_epilogue.cu", "replaces": None,
            "launches_match_path": launches, "blocks": rows}


def stored(fix, tag, keys=POSE_KEYS):
    return tuple(fix[f"{k}_{tag}"] for k in keys)


def corners_agree(name, out, ref, slots=0.02, near_share=0.98):
    """Hold (keypoints, valid, refined) numpy arrays to the stored JAX ones;
    returns the per-slot mask of slots that agree and lie within 0.125 px."""
    import torch

    kp, v, r = (torch.from_numpy(np.asarray(a)) for a in out[:3])
    kr, vr, rr = (torch.from_numpy(a) for a in ref[:3])
    slot, coord = mismatch(kp, v, kr, vr)
    agree = v & vr & ((kp - kr).abs().amax(-1) == 0)
    close = (r - rr).abs().amax(-1) <= 0.125
    near = float(close[agree].float().mean())
    log(f"{name}: slot mismatch {slot:.4f}, coord mismatch {coord:.4f}, |Δrefined|≤0.125 "
        f"on {near:.4f} of {int(agree.sum())} agreeing slots")
    require(slot <= slots and coord <= slots, f"{name}: keypoints disagree with JAX")
    require(near >= near_share, f"{name}: refined corners disagree with JAX")
    return (agree & close).numpy()


def pose_agrees(name, out, ref, good_slots=None, rad=0.02, rel=0.02, px=None,
                max_rms=None):
    """``ok`` differs on at most one frame (on none with ``good_slots`` None,
    the solver-only check); on the frames held, |Δrvec| ≤ rad, |Δtvec| ≤
    rel·|tvec| and, with ``px``, |Δrms| ≤ px. Held: ``ok`` true in both and,
    given ``good_slots``, every slot valid in either within 0.125 px."""
    v, ok, rvec, tvec, rms = (np.asarray(out[i]) for i in (1, 3, 4, 5, 6))
    vr, ok_r, rvec_r, tvec_r, rms_r = (ref[i] for i in (1, 3, 4, 5, 6))
    differ = int((ok != ok_r).sum())
    held = ok & ok_r
    if good_slots is not None:
        held &= (good_slots | ~(v | vr)).all(-1)
    if max_rms is not None:
        held &= rms_r <= max_rms
    d_r = np.abs(rvec - rvec_r).max(-1)
    d_t = np.linalg.norm(tvec - tvec_r, axis=-1) / np.maximum(
        np.linalg.norm(tvec_r, axis=-1), 1e-12)
    d_rms = np.abs(np.where(held, rms - rms_r, 0.0))
    log(f"{name}: ok differs on {differ} of {len(ok)} frames ({int(ok_r.sum())} ok in JAX); "
        f"{int(held.sum())} frames held: max |Δrvec| {d_r[held].max(initial=0):.2e} rad, "
        f"max |Δtvec|/|tvec| {d_t[held].max(initial=0):.2e}, max |Δrms| {d_rms.max():.2e} px; "
        f"all frames: |Δrvec| {' '.join(f'{x:.1e}' for x in d_r)}")
    require(differ <= (0 if good_slots is None else 1), f"{name}: ok disagrees with JAX")
    require(held.sum() >= len(ok) // 2, f"{name}: too few frames to compare poses on")
    require(d_r[held].max() <= rad and d_t[held].max() <= rel, f"{name}: pose disagrees")
    require(px is None or d_rms.max() <= px, f"{name}: reprojection rms disagrees")
    require(np.isfinite(rvec).all() and np.isfinite(tvec).all(), f"{name}: non-finite pose")


def phase_pose_fixture(pipes, fix, dev):
    import torch

    from deepcharuco_tpu_torch.pipeline import Camera
    from deepcharuco_tpu_torch.pnp import solve_pnp_batch

    ref = stored(fix, "bf16")
    for name, pipe in pipes.items():
        reset_launches()
        out = pipe.detect_with_pose(fix["frames"])
        counts = launch_counts()
        require(len(out) == 7, f"[{name}] detect_with_pose returned {len(out)} arrays")
        good = corners_agree(f"phase 7 pose path [{name}] vs JAX bf16", out, ref)
        pose_agrees(f"phase 7 pose path [{name}] vs JAX bf16", out, ref, good)
        want = (1, 0) if name == "heads+decode" else (0, 1)
        require(counts == want, f"[{name}] kernel launches {counts}, expected {want}")
        require(pnp_launch_count() == 1,
                f"[{name}] {pnp_launch_count()} pose kernel launches in one request")
    # the solver alone, on the corners JAX found
    obj = next(iter(pipes.values())).object_points
    cam_lo = Camera(K=fix["K_hi"], dist=fix["dist"]).scaled(0.5)
    for tag, K in (("f32", fix["K"]), ("bf16", fix["K"]), ("hires_f32", cam_lo.K)):
        ref = stored(fix, tag)
        to = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        got = solve_pnp_batch(obj, to(ref[2]), to(ref[1]), to(K), to(fix["dist"]))
        out = (None, ref[1], None) + tuple(t.cpu().numpy() for t in got)
        pose_agrees(f"phase 7 solve_pnp_batch on the stored JAX corners [{tag}]", out, ref,
                    rad=1e-3, rel=1e-3, px=1e-3, max_rms=10.0)


def offset_variables(rv, fix):
    """RefineNet variables plus the fixture's seeded offset branch."""
    rv = {coll: dict(layers) for coll, layers in rv.items()}
    for key in fix:
        if key.startswith("rn_offset/"):
            _, coll, layer, *rest = key.split("/")
            node = rv[coll].setdefault(layer, {})
            for part in rest[:-1]:
                node = node.setdefault(part, {})
            node[rest[-1]] = fix[key].astype(np.float32)
    return rv


def phase_variants(cfg, dv, rv, fix, dev):
    from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline, load_pipeline

    cam_hi = Camera(K=fix["K_hi"], dist=fix["dist"])
    ref = stored(fix, "hires_bf16")
    hi_pipes = {}
    for fused in (False, True):
        name = f"phase 8 hires=2, 32-px, soft [fused_head={fused}] vs JAX bf16"
        pipe = load_pipeline(cfg, DET, RN32, camera=cam_hi, rn_patch_size=32, hires=2,
                             fused_head=fused, device=dev)
        out = pipe.detect_with_pose(fix["frames_hi"])
        require(np.asarray(out[2])[np.asarray(out[1])].max() < 320,
                f"{name}: corners are not in low-res units")
        good = corners_agree(name, out, ref, slots=2 / 64, near_share=0.95)
        pose_agrees(name, out, ref, good)
        hi_pipes[fused] = pipe
    top4 = InferencePipeline(cfg, dv, rv, decode_capacity=4, device=dev)
    out = top4.detect(fix["frames"])
    require(out[0].shape == (8, N_IDS, 4, 2) and out[1].shape == (8, N_IDS, 4),
            f"decode_capacity=4: shapes {out[0].shape}, {out[1].shape}")
    corners_agree("phase 8 decode_capacity=4 vs JAX bf16", out,
                  stored(fix, "top4", POSE_KEYS[:3]))
    rvo = offset_variables(rv, fix)
    for fused in (False, True):
        avg = InferencePipeline(cfg, dv, rvo, rn_decode="avg", fused_head=fused, device=dev)
        corners_agree(f"phase 8 rn_decode=avg [fused_head={fused}] vs JAX bf16",
                      avg.detect(fix["frames"]),
                      (fix["keypoints_bf16"], fix["valid_bf16"], fix["refined_avg_bf16"]))
    return hi_pipes[False]


def host_and_wall_ms(fn, repeats: int = 3):
    """(ms the host takes to enqueue ``fn``'s work, ms until the card has
    finished it), the card idle at the start; the mean of ``repeats``."""
    import torch

    host = wall = 0.0
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host += (t1 - t0) * 1e3 / repeats
        wall += (t2 - t0) * 1e3 / repeats
    return host, wall


def phase_pose_serve(pipes, hi_pipe, fix, rng, dev, detect_serve):
    import torch

    from deepcharuco_tpu_torch.ops import extract_patches
    from deepcharuco_tpu_torch.pipeline import full_forward, two_stage_forward
    from deepcharuco_tpu_torch.pnp import project_points, solve_pnp, solve_pnp_plain

    requests = 8
    batches = make_batches(fix["frames"], requests * len(pipes), rng)
    for pipe in pipes.values():          # warm-up: cuDNN plans, the allocator
        pipe.detect_with_pose(batches[0])
    torch.cuda.synchronize()
    reset_launches()
    pose = {}
    for i, (name, pipe) in enumerate(pipes.items()):
        before = pnp_launch_count()
        t0 = time.perf_counter()
        n_ok = 0
        for b in batches[i * requests:(i + 1) * requests]:
            kp, v, r, ok, rvec, tvec, rms = pipe.detect_with_pose(b)
            require(r.shape == (N, N_IDS, 2) and ok.shape == (N,) and rvec.shape == (N, 3)
                    and tvec.shape == (N, 3) and rms.shape == (N,)
                    and np.isfinite(rvec).all() and np.isfinite(tvec).all()
                    and np.isfinite(rms[ok]).all() and (tvec[ok, 2] > 0).all(),
                    f"[{name}] bad pose output")
            n_ok += int(ok.sum())
        dt = time.perf_counter() - t0
        pose[name] = {"fps": N * requests / dt, "ms_per_batch": 1e3 * dt / requests,
                      "ok_share": n_ok / (N * requests),
                      "detect_ms_per_batch": detect_serve[name]["ms_per_batch"]}
        log(f"phase 9 serve pose [{name}]: {requests} requests × {N} frames: "
            f"{pose[name]['fps']:.1f} fps, {pose[name]['ms_per_batch']:.3f} ms/batch "
            f"(detect alone, phase 5: {detect_serve[name]['ms_per_batch']:.3f}), "
            f"ok on {pose[name]['ok_share']:.3f} of the frames")
        require(n_ok >= N * requests // 2, f"[{name}] the pose path solved too few frames")
        require(pnp_launch_count() - before == requests,
                f"[{name}] {pnp_launch_count() - before} pose kernel launches in {requests} "
                "requests, expected one each")
    launches = {"decode": launch_counts()[0], "fused_head_decode": launch_counts()[1],
                "pnp": pnp_launch_count()}
    log(f"phase 9 launches on the pose path: {launches}")
    require(all(v >= requests for v in launches.values()),
            f"a kernel of the pose path was not launched: {launches}")

    # the same path through the functional entry point, whose tail is the same kernel
    pipe = pipes["heads+decode"]
    func_path = lambda b: tuple(t.cpu().numpy() for t in full_forward(
        pipe.detector, pipe.refinenet, b, N_IDS, pipe.object_points, fix["K"], fix["dist"],
        device=dev))
    same = all(np.array_equal(a, b, equal_nan=True) for a, b in
               zip(func_path(batches[0]), pipe.detect_with_pose(batches[0])))
    require(same, "full_forward and detect_with_pose differ")
    t0 = time.perf_counter()
    for b in batches[:4]:
        func_path(b)
    func_ms = 1e3 * (time.perf_counter() - t0) / 4
    pose["heads+decode"]["full_forward_ms_per_batch"] = func_ms
    log(f"phase 9 serve pose [heads+decode] through full_forward: {func_ms:.3f} ms/batch "
        f"over 4 requests, outputs identical to detect_with_pose's")

    # the pose tail alone on one batch's corners, at the offline cells' 256 frames and
    # the stream cell's 56: the pose kernel against the plain path on the card
    _, v, r = two_stage_forward(pipe.detector, pipe.refinenet, batches[0], N_IDS, device=dev)
    r, v = r.float().clone(), v.clone()
    K, dist = (torch.from_numpy(fix[k]).to(dev) for k in ("K", "dist"))
    tail = {}
    for n in (N, 56):
        rn, vn = r[:n].contiguous(), v[:n].contiguous()
        # the pipeline's own camera tensors (12 coefficients): what solve_pose
        # launches, and what the pose graph captured before the kernel
        kern = lambda: solve_pnp(pipe.object_points, rn, vn, pipe._K, pipe._dist,
                                 iters=pipe.pnp_iters)
        fns = {"kernel": lambda: pipe.solve_pose(rn, vn),
               "plain": lambda: solve_pnp_plain(pipe.object_points, rn, vn, pipe._K,
                                                pipe._dist, iters=pipe.pnp_iters)}
        ops = device_ops(kern)[0]
        for tag, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            reset_launches()
            host, wall = host_and_wall_ms(fn)
            counts = launch_counts() + (pnp_launch_count(),)
            tail[f"{tag}_{n}"] = {"host_ms": host, "wall_ms": wall,
                                  "launches_b1_b2_pnp": counts}
            log(f"phase 9 pose tail [{tag}], batch {n}: host {host:.3f} ms to enqueue, "
                f"{wall:.3f} ms to finish (mean of 3 calls); B1/B2/pose kernel launches in "
                f"the 3 calls {counts}")
            want = (0, 0, 3) if tag == "kernel" else (0, 0, 0)
            require(counts == want, f"the pose tail [{tag}] launched {counts}, expected {want}")
        kernel_ms = graph_ms(kern)
        plain_ms = graph_ms(fns["plain"], iters=2, replays=3)
        flops, nbytes = pnp_work(pipe.object_points, rn, vn, pipe._K, pipe._dist,
                                 pipe.pnp_iters)
        t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
        bound_ms = 1e3 * max(t_ops, t_bytes)
        a, b = [t.cpu() for t in fns["plain"]()], [t.cpu() for t in fns["kernel"]()]
        # frames the benchmark judges: 5 corners or more, fitted within 1 px; on
        # fewer corners, or with a wrong-id corner, two float32 solvers may end
        # in different minima or one of them in NaN (the plain one on the card
        # and on the CPU do too)
        many = vn.cpu().sum(-1) >= 5
        held = a[0] & b[0] & many & (a[3] <= 1.0)
        fit = lambda o: pose_rms64(pipe.object_points.cpu(), rn.cpu(), vn.cpu(), K.cpu(),
                                   dist.cpu(), o[1], o[2])[held]
        proj = lambda o: project_points(pipe.object_points.cpu().double(), o[1][held].double(),
                                        o[2][held].double(), K.cpu().double(),
                                        dist.cpu().double())
        gaps = (proj(a) - proj(b)).norm(dim=-1).amax(-1)
        fit_gap = float((fit(b) - fit(a)).abs().max()) if held.any() else 0.0
        rms_gap = float((a[3][held] - b[3][held]).abs().max()) if held.any() else 0.0
        tail[f"kernel_{n}"].update({
            "device_ms": kernel_ms, "plain_device_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops,
            "bytes": nbytes, "device_ops": ops, "ok_differs": int((a[0] != b[0]).sum()),
            "ok_differs_5_or_more": int((a[0] != b[0])[many].sum()), "held": int(held.sum()),
            "proj_gap_px_median": float(gaps.median()) if held.any() else 0.0,
            "proj_gap_px_max": float(gaps.max()) if held.any() else 0.0,
            "fit_gap_px": fit_gap, "rms_gap_px": rms_gap})
        log(f"phase 9 pose kernel, batch {n}: {kernel_ms:.4f} ms a call on the device (CUDA "
            f"graph of 20 calls), {ops} device operations a call (profiler; None: it recorded "
            f"none); plain path {plain_ms:.4f} ms (CUDA graph of 2 calls); bound "
            f"{bound_ms:.4f} ms ({flops / 1e6:.1f} MFLOP of the plain path at "
            f"{PEAK_F32 / 1e12:.0f} TFLOP/s, {nbytes} bytes); ok on {int(b[0].sum())} of {n}; "
            f"against the plain path: ok differs on {tail[f'kernel_{n}']['ok_differs']} ("
            f"{tail[f'kernel_{n}']['ok_differs_5_or_more']} with 5 corners or more); on "
            f"{int(held.sum())} frames fitted within 1 px projections apart by "
            f"{tail[f'kernel_{n}']['proj_gap_px_median']:.3g} px (median), "
            f"{tail[f'kernel_{n}']['proj_gap_px_max']:.3g} px (max), float64 RMS within "
            f"{fit_gap:.3g} px, reported RMS within {rms_gap:.3g} px")
        require(tail[f"kernel_{n}"]["ok_differs_5_or_more"] == 0 and fit_gap <= 1e-4
                and rms_gap <= 1e-4, "the pose kernel disagrees with the plain path")
    # one profiled request: the card's busy share of the pose path
    for name, p in pipes.items():
        ops, busy = device_ops(lambda: p.detect_with_pose(batches[1]))
        wall = pose[name]["ms_per_batch"]
        pose[name].update({"device_ops_per_batch": ops, "device_busy_ms": busy})
        log(f"phase 9 pose path [{name}]: {ops} device operations, {busy:.3f} ms summed "
            f"device time per batch against {wall:.3f} ms per batch served "
            f"(idle share {max(0.0, 1 - busy / wall):.3f})")

    # hi-res requests: scale 2, 64 frames of 480×640, 32-px RefineNet, soft decode
    n_hi = 64
    hi_batches = make_batches(fix["frames_hi"], 4, rng, n=n_hi)
    for _ in range(2):      # warm-up: cuDNN plans at this size, the graph, the allocator
        hi_pipe.detect_with_pose(hi_batches[0])
    hi = {"with_pose_ms": [], "detect_ms": []}
    for b in hi_batches[1:]:
        for key, fn in (("with_pose_ms", hi_pipe.detect_with_pose), ("detect_ms", hi_pipe.detect)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(b)
            hi[key].append((time.perf_counter() - t0) * 1e3)
        require(out[2].shape == (n_hi, N_IDS, 2) and np.isfinite(out[2]).all(),
                "bad hi-res output")
    log(f"phase 9 hi-res request (scale 2, {n_hi} frames of 480×640): detect_with_pose "
        f"{[round(x, 3) for x in hi['with_pose_ms']]} ms, detect "
        f"{[round(x, 3) for x in hi['detect_ms']]} ms")

    # the patch gather at the tap's sizes
    gather = {}
    for n, h, w, p in ((N, 240, 320, 24), (N, 480, 640, 32), (n_hi, 480, 640, 32),
                       (N, 960, 1280, 32)):
        g = torch.rand(n, h, w, device=dev)
        kp = torch.rand(n, N_IDS, 2, device=dev) * torch.tensor([w, h], device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: extract_patches(g, kp, p))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        gather[f"{n}x{h}x{w},P={p}"] = {"ms": ms, "peak_mib": peak,
                                        "patches_mib": n * N_IDS * p * p * 4 / 2 ** 20}
        log(f"phase 9 patch gather N={n} {h}×{w} P={p}: {ms:.4f} ms, peak {peak:.1f} MiB "
            f"above the frames ({n * N_IDS * p * p * 4 / 2 ** 20:.1f} MiB of patches)")
        del g, kp
    return {"serve": pose, "tail": tail, "hires": hi, "gather": gather}, launches


def drop_slots(arrays, drop):
    """(keypoints, valid, refined, ...) with the slots of ``drop`` made
    invalid on a copy of ``valid``."""
    arrays = [np.asarray(a) for a in arrays]
    arrays[1] = arrays[1] & ~drop
    return tuple(arrays)


def ms_per_batch(fn, batches):
    """Host-clock ms per call of ``fn`` over ``batches``, every result on the
    host; the card idle at the start."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        fn(b)
    return 1e3 * (time.perf_counter() - t0) / len(batches)


def phase_geom(cfg, pipes, fix, rng, dev):
    import torch

    from deepcharuco_tpu_torch.pipeline import (Camera, load_pipeline, two_stage_forward,
                                                two_stage_forward_hires)

    noise = (fix["geom_noise_g"], fix["geom_noise_gs"])
    cam = Camera(K=fix["K"], dist=fix["dist"])
    cam_hi = Camera(K=fix["K_hi"], dist=fix["dist"])
    served = {}
    for hires in (False, True):
        for fill in (False, True):
            tag = ("hires_" if hires else "") + ("geomfill" if fill else "geom") + "_bf16"
            name = f"phase 10 geometry decode [{tag}] vs JAX bf16"
            kw = dict(geom_decode=True, geom_fill=fill, geom_noise=noise, device=dev)
            if hires:
                pipe = load_pipeline(cfg, DET, RN32, camera=cam_hi, rn_patch_size=32, hires=2,
                                     **kw)
                frames = fix["frames_hi"]
                filled = two_stage_forward_hires(
                    pipe.detector, pipe.refinenet, frames, N_IDS, rn_decode=pipe.rn_decode,
                    scale=2, return_filled=True, device=dev, **pipe._geom)[3]
            else:
                pipe = load_pipeline(cfg, DET, RN, camera=cam, **kw)
                frames = fix["frames"]
                filled = two_stage_forward(
                    pipe.detector, pipe.refinenet, frames, N_IDS, rn_decode=pipe.rn_decode,
                    return_filled=True, device=dev, **pipe._geom)[3]
            filled = filled.cpu().numpy()
            ref = stored(fix, tag, POSE_KEYS + ("filled",))
            reset_launches()
            out = pipe.detect_with_pose(frames)
            require(launch_counts() == (0, 0),
                    f"{name}: the geometry decode launched a one-slot decode kernel")
            same_fill = float((filled == ref[7]).mean())
            log(f"{name}: filled equal on {same_fill:.4f} of the slots "
                f"({int(filled.sum())} filled here, {int(ref[7].sum())} in JAX; "
                f"{int(np.asarray(out[1]).sum())} valid)")
            require(same_fill >= 0.98, f"{name}: filled masks disagree")
            require(fill or not filled.any(), f"{name}: filled without geom_fill")
            require(not (filled & ~np.asarray(out[1])).any(), f"{name}: a filled slot is invalid")
            either = filled | ref[7]
            limits = dict(slots=2 / 64, near_share=0.95) if hires else {}
            good = corners_agree(name, drop_slots(out, either), drop_slots(ref, either),
                                 **limits)
            pose_agrees(name, out, ref, good | either)
            if not hires:
                served["geom+fill" if fill else "geom"] = pipe
    # ms per batch of 256 beside the parity decode's, the same batches in turns
    batches = make_batches(fix["frames"], 5, rng)
    served = {"parity": pipes["heads+decode"], **served}
    for pipe in served.values():
        pipe.detect_with_pose(batches[0])
    ms = {name: [] for name in served}
    for _ in range(2):
        for name, pipe in served.items():
            ms[name].append(ms_per_batch(pipe.detect_with_pose, batches[1:]))
    ops = {name: device_ops(lambda: pipe.detect_with_pose(batches[1]))
           for name, pipe in served.items()}
    # the host's time to enqueue one batch (frames already on the card)
    # beside the time until the card has finished it
    on_card = torch.from_numpy(batches[1]).to(dev)
    host = {name: host_and_wall_ms(lambda: pipe.forward_device(on_card, True))
            for name, pipe in served.items()}
    for name in served:
        log(f"phase 10 detect_with_pose [{name}], batch {N}: "
            f"{' / '.join(f'{x:.3f}' for x in ms[name])} ms per batch (4 requests, two "
            f"rounds in turns); {ops[name][0]} device operations, {ops[name][1]:.3f} ms "
            f"summed device time; forward_device: {host[name][0]:.3f} ms on the host to "
            f"enqueue, {host[name][1]:.3f} ms to finish")
    stats = {name: {"ms_per_batch": ms[name], "device_ops": ops[name][0],
                    "device_busy_ms": ops[name][1], "host_enqueue_ms": host[name][0],
                    "finish_ms": host[name][1]} for name in served}
    del served["parity"]
    return stats, served


def phase_int8(cfg, pipes, fix, rng, dev):
    import torch

    from deepcharuco_tpu_torch.models.quant import QuantDetector, qvars_from_npz
    from deepcharuco_tpu_torch.ops.image import normalize_gray
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    pipe = load_pipeline(cfg, INT8, RN, device=dev)
    require(isinstance(pipe.detector, QuantDetector), "the int8 artifact was not recognised")
    g = normalize_gray(torch.from_numpy(fix["frames"]).to(dev))
    cpu_det = QuantDetector(qvars_from_npz(INT8), N_IDS).eval()
    acc_card, acc_cpu = [], []
    with torch.inference_mode():
        heads = pipe.detector(g, accumulators=acc_card)
        heads_cpu = cpu_det(g.cpu(), accumulators=acc_cpu)
    torch.cuda.synchronize()
    require(len(acc_card) == len(acc_cpu) == 12, "expected 12 accumulators")
    differ = [int((a.cpu() != b).sum()) for a, b in zip(acc_card, acc_cpu)]
    sizes = [a.numel() for a in acc_cpu]
    peak = max(int(a.abs().max()) for a in acc_cpu)
    d_logit = max(float((heads[k].cpu() - heads_cpu[k]).abs().max()) for k in heads)
    log(f"phase 11 int8 accumulators, card (im2col + torch._int_mm) against the CPU's int32 "
        f"conv2d on the {len(fix['frames'])} fixture frames: {sum(differ)} of {sum(sizes)} "
        f"differ over 12 layers ({differ}); largest |accumulator| {peak} (2^24 = 16777216); "
        f"max |Δlogit| {d_logit:.3e}")
    require(all(a.dtype == torch.int32 for a in acc_card), "accumulators are not int32")
    require(sum(differ) == 0, "int32 accumulators on the card differ from the CPU route's")
    # layer k's accumulators are equal and layer k+1's too, so the int8
    # activations between them are: no epilogue value flipped
    log("phase 11 int8 epilogue: 0 activations flipped between the card and the CPU "
        "(every next layer's accumulators are equal)")
    reset_launches()
    out = pipe.detect(fix["frames"])
    require(launch_counts() == (1, 0),
            "the int8 path did not decode through the decode kernel")
    corners_agree("phase 11 int8 detect vs the JAX int8 pipeline (bf16 RefineNet)", out,
                  stored(fix, "int8", POSE_KEYS[:3]))
    try:
        load_pipeline(cfg, INT8, RN, fused_head=True, device=dev)
    except ValueError as e:
        log(f"phase 11 int8 with fused_head=True raises ValueError: {str(e)[:60]}...")
    else:
        require(False, "int8 with fused_head=True did not raise")

    batches = make_batches(fix["frames"], 4, rng)
    bf16 = pipes["heads+decode"]
    for p in (pipe, bf16):
        p.detect(batches[0])
    launches = 0
    ms = {"int8": [], "bf16": []}
    det_ms = {"int8": [], "bf16": []}
    gb = normalize_gray(torch.from_numpy(batches[1]).to(dev))
    peak_gib = {}
    for _ in range(2):
        for name, p in (("bf16", bf16), ("int8", pipe)):
            reset_launches()
            ms[name].append(ms_per_batch(p.detect, batches[1:]))
            launches += launch_counts()[0] if name == "int8" else 0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                det_ms[name].append(cuda_ms(lambda: p.detector(gb), iters=3, warmup=1))
            peak_gib[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.detector(gb)
        torch.cuda.synchronize()
    by_op = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    total_us = sum(e.device_time_total for e in by_op)
    log(f"phase 11 [int8] one detector call by device operation ({total_us / 1e3:.3f} ms): "
        + "; ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.2f} ms ×{e.count}"
                    for e in by_op[:8]))
    for name in ms:
        log(f"phase 11 [{name}] batch {N}: detector alone "
            f"{' / '.join(f'{x:.3f}' for x in det_ms[name])} ms (peak {peak_gib[name]:.2f} GiB "
            f"above the frames), detect {' / '.join(f'{x:.3f}' for x in ms[name])} ms per "
            f"batch (3 requests, two rounds in turns)")
    log(f"phase 11 launches of the decode kernel in the int8 pipeline's 6 requests: {launches}")
    require(launches == 6, f"the decode kernel ran {launches} times in 6 int8 requests")
    return {"detector_ms": det_ms, "detect_ms_per_batch": ms, "detector_peak_gib": peak_gib,
            "accumulators_differ": sum(differ), "max_abs_accumulator": peak}, launches


def busy_share(fn):
    """Profile ``fn`` and return (ms the card was busy: the union of its
    operations' intervals, ms from its first operation's start to its last
    one's end, number of operations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    require(bool(spans), "torch.profiler saw no device operation")
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy / 1e3, (max(b for _, b in spans) - spans[0][0]) / 1e3, len(spans)


def equal_results(got, want) -> bool:
    """Bit for bit, NaN equal to NaN; the first array that differs is logged."""
    for i, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a, b, equal_nan=True):
            a, b = np.asarray(a), np.asarray(b)
            where = np.argwhere(a != b)[:3].tolist() if a.shape == b.shape else "shapes"
            log(f"  array {i} differs: {a.shape} {a.dtype} against {b.shape} {b.dtype} at {where}")
            return False
    return True


def stream_server_equal(tag, got, want, keys):
    """Every step of a ``StreamServer`` run over N streams holds all streams
    and equals the synchronous call on that step's batch."""
    require(len(got) == len(want), f"[{tag}] StreamServer gave {len(got)} steps")
    for s, res in enumerate(got):
        require(sorted(res) == list(range(N)), f"[{tag}] StreamServer step {s}: streams")
        rows = tuple(np.stack([res[i][k] for i in range(N)]) for k in keys)
        require(equal_results(rows, want[s]),
                f"[{tag}] StreamServer step {s} differs from the synchronous call")


def phase_streams(pipes, geom_pipes, fix, rng, dev):
    import torch

    from deepcharuco_tpu_torch import serving
    from deepcharuco_tpu_torch.serving import (RESULT_KEYS, DeviceQueueServer, StreamServer,
                                               VideoStream, pipelined_map)

    steps, chunk = 8, 8
    few = N // chunk
    batches = make_batches(fix["frames"], steps, rng)
    # 256 streams, one frame of each per step: step s is batches[s]
    wide = lambda: [VideoStream(iter([b[i] for b in batches])) for i in range(N)]
    # 32 streams × 64 steps: chunk k of 8 steps is batches[k], row = step·32 + stream
    narrow = lambda: [VideoStream(iter([b[s * few + j] for b in batches for s in range(chunk)]))
                      for j in range(few)]
    out = {}
    launches = {}
    for name, pipe in pipes.items():
        for with_pose in (True, False):
            tag = f"{name}, {'with' if with_pose else 'no'} pose"
            keys = RESULT_KEYS if with_pose else RESULT_KEYS[:3]
            call = pipe.detect_with_pose if with_pose else pipe.detect
            want = [call(b) for b in batches]
            runs = {
                "StreamServer": lambda: list(StreamServer(pipe, wide(), with_pose).run()),
                "DeviceQueueServer": lambda: list(DeviceQueueServer(
                    pipe, narrow(), chunk=chunk, with_pose=with_pose).run()),
                "pipelined_map": lambda: list(pipelined_map(
                    lambda x: pipe.forward_device(x, with_pose), batches, device=dev)),
            }
            got, per_run = {}, {}
            for k, run in runs.items():                     # also the warm-up
                reset_launches()
                got[k] = run()
                per_run[k] = launch_counts() + (pnp_launch_count(),)
            launches[tag] = tuple(sum(c[i] for c in per_run.values()) for i in range(3))
            require(len(got["StreamServer"]) == steps
                    and len(got["DeviceQueueServer"]) == steps * chunk
                    and len(got["pipelined_map"]) == steps, f"[{tag}] wrong number of steps")
            stream_server_equal(tag, got["StreamServer"], want, keys)
            for t, res in enumerate(got["DeviceQueueServer"]):
                k, s = divmod(t, chunk)
                require(sorted(res) == list(range(few)), f"[{tag}] DeviceQueueServer step {t}")
                rows = tuple(np.stack([res[j][key] for j in range(few)]) for key in keys)
                require(equal_results(rows, tuple(w[s * few:(s + 1) * few] for w in want[k])),
                        f"[{tag}] DeviceQueueServer step {t} differs from the synchronous call")
            for s, res in enumerate(got["pipelined_map"]):
                require(equal_results(res, want[s]),
                        f"[{tag}] pipelined_map batch {s} differs from the synchronous call")
            log(f"phase 12 [{tag}]: StreamServer ({N} streams × {steps} steps), "
                f"DeviceQueueServer ({few} streams × {steps * chunk} steps, chunk {chunk}) and "
                f"pipelined_map equal the synchronous calls bit for bit on {steps} batches; "
                f"launches B1/B2/pose kernel {per_run}")
            # one launch of each kernel a launched step: StreamServer's and
            # pipelined_map's 8 steps, DeviceQueueServer's 8 blocks of 8 steps
            want_l = ((steps, 0) if name == "heads+decode" else (0, steps)) \
                + (steps if with_pose else 0,)
            require(all(c == want_l for c in per_run.values()),
                    f"[{tag}] B1/B2/pose kernel launches {per_run}, expected {want_l} each")
            runs = {"synchronous": lambda: [call(b) for b in batches], **runs}
            fps = {k: [] for k in runs}
            for _ in range(2):
                for k, run in runs.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    fps[k].append(N * steps / (time.perf_counter() - t0))
            idle = {}
            for k in ("synchronous", "StreamServer"):
                busy, span, n_ops = busy_share(runs[k])
                idle[k] = {"busy_ms": busy, "span_ms": span, "device_ops": n_ops,
                           "idle_share": 1 - busy / span}
            out[tag] = {"fps": fps, "idle": idle}
            log(f"phase 12 [{tag}] fps over {steps} batches of {N}, two rounds in turns: "
                + "; ".join(f"{k} {' / '.join(f'{x:.1f}' for x in v)}" for k, v in fps.items()))
            log(f"phase 12 [{tag}] the card under torch.profiler: "
                + "; ".join(f"{k}: busy {v['busy_ms']:.3f} of {v['span_ms']:.3f} ms, idle share "
                            f"{v['idle_share']:.4f}" for k, v in idle.items()))

    # the geometry decode, whose enqueue holds the host longer than the
    # detector holds the card: served against synchronous, with pose
    for name, pipe in geom_pipes.items():
        tag = f"{name}, with pose"
        want = [pipe.detect_with_pose(b) for b in batches]
        runs = {"synchronous": lambda: [pipe.detect_with_pose(b) for b in batches],
                "StreamServer": lambda: list(StreamServer(pipe, wide(), True).run())}
        reset_launches()
        stream_server_equal(tag, runs["StreamServer"](), want, RESULT_KEYS)
        require(pnp_launch_count() == steps,
                f"[{tag}] {pnp_launch_count()} pose kernel launches in {steps} steps")
        fps = {k: [] for k in runs}
        for _ in range(2):
            for k, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                fps[k].append(N * steps / (time.perf_counter() - t0))
        out[tag] = {"fps": fps}
        log(f"phase 12 [{tag}] StreamServer equals the synchronous calls bit for bit; fps over "
            f"{steps} batches of {N}, two rounds in turns: "
            + "; ".join(f"{k} {' / '.join(f'{x:.1f}' for x in v)}" for k, v in fps.items()))

    # peak device memory per input pixel of served batches, bf16
    bpp = {}
    cases = [(f"240x320, {name}, {'with' if pose else 'no'} pose", p, pose, fix["frames"], N)
             for name, p in pipes.items() for pose in (False, True)]
    cases.append(("480x640, heads+decode, no pose", pipes["heads+decode"], False,
                  fix["frames_hi"], 64))
    for tag, p, pose, frames, n in cases:
        block = make_batches(frames, 3, rng, n=n)
        h, w = block[0].shape[1:3]
        streams = lambda: [VideoStream(iter([b[i] for b in block])) for i in range(n)]
        list(StreamServer(p, streams(), pose).run())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        list(StreamServer(p, streams(), pose).run())
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        bpp[tag] = peak / (n * h * w)
        log(f"phase 12 peak device memory of served batches, {n} frames of {tag}, bf16: "
            f"{peak / 2 ** 20:.1f} MiB above the pipeline at rest = {bpp[tag]:.1f} bytes per "
            f"input pixel (serving.TWO_STAGE_BYTES_PER_PIXEL = "
            f"{serving.TWO_STAGE_BYTES_PER_PIXEL})")
    total = torch.cuda.get_device_properties(dev).total_memory
    log(f"phase 12 budget: {total} bytes of device memory → ceiling "
        f"{serving.two_stage_batch_ceiling(480, 640, device=dev)} frames of 480×640, "
        f"{serving.two_stage_batch_ceiling(240, 320, device=dev)} of 240×320")
    require(max(bpp.values()) <= serving.TWO_STAGE_BYTES_PER_PIXEL,
            f"serving.TWO_STAGE_BYTES_PER_PIXEL = {serving.TWO_STAGE_BYTES_PER_PIXEL} does not "
            f"cover the measured {bpp}")
    out["bytes_per_pixel"] = bpp
    return out, launches


SYNTH_TOL = 1e-3       # |Δ| of images, patches, heatmaps (normalized units)
FLIP_SHARE = 0.01      # share of pixels allowed a one-level (1/255) low-light rounding flip
STEP_REL = 1e-4        # losses against the stored JAX float32 ones, relative
STATS_TOL = 1e-3       # running statistics, of each layer's largest value
RESUME_REL = 0.35      # a resumed run's val_loss against the uninterrupted run's


def fixture_synthesizer(name, cfg, dev):
    from deepcharuco_tpu_torch.data import device_synth as P

    if name == "det_base":
        return P.DeviceSynthesizer(cfg, device=dev)
    if name == "det_diet":
        return P.DeviceSynthesizer(cfg, perspective_p=0.5, axis_snap_p=0.5, low_gain_p=0.5,
                                   device=dev)
    if name == "frame_patch":
        return P.FramePatchSynthesizer(cfg, perspective_p=0.5, device=dev)
    return P.DeviceRefineSynthesizer(cfg, device=dev)


def phase_synthesis(cfg, fix, dev):
    """The stored JAX draws rendered on the card against the stored JAX
    renders; then the synthesisers' time per training batch."""
    import torch

    from deepcharuco_tpu_torch.data.device_synth import load_draws

    out = {}
    for name in ("det_base", "det_diet", "frame_patch", "refine"):
        synth = fixture_synthesizer(name, cfg, dev)
        draws = load_draws(fix, f"synth/{name}/draw", dev)
        want = lambda k: torch.from_numpy(np.asarray(
            fix[f"synth/{name}/out/{k}"], np.float32 if k == "images" else None))
        if name.startswith("det"):
            img, loc, ids, kpts, vis = (t.cpu() for t in synth.render_full(draws))
            for k, t in (("loc", loc), ("ids", ids), ("visible", vis)):
                require(torch.equal(t, want(k)), f"phase 13 synthesis [{name}]: {k} differs")
            diff = (img - want("images")).abs()
            flips = (diff - 1 / 255).abs() <= SYNTH_TOL
            rest = torch.where(flips, 0.0, diff)
            over = int((rest > SYNTH_TOL).sum())
            out[name] = {"labels_equal": True, "pixels": diff.numel(), "flips": int(flips.sum()),
                         "over_limit": over, "max_abs_err": float(rest.max()),
                         "kpts_max_abs_err": float((kpts - want("kpts")).abs().max()),
                         "visible": int(vis.sum())}
            log(f"phase 13 synthesis [{name}] on the stored JAX draws: loc, ids, visible equal "
                f"({int(vis.sum())} visible corners); images: max |Δ| {float(rest.max()):.2e} "
                f"outside {int(flips.sum())} one-level low-light flips of {diff.numel()} pixels, "
                f"{over} pixels over {SYNTH_TOL}; max |Δkpts| {out[name]['kpts_max_abs_err']:.2e}")
            require(over == 0 and float(flips.float().mean()) <= FLIP_SHARE,
                    f"phase 13 synthesis [{name}]: images disagree with JAX")
        else:
            got = synth.render(draws) if name == "refine" else synth.render(draws, 8)
            errs = [float((g.cpu() - want(k)).abs().max()) for g, k in zip(got, ("patches",
                                                                              "heatmaps"))]
            out[name] = {"patches_max_abs_err": errs[0], "heatmaps_max_abs_err": errs[1]}
            log(f"phase 13 synthesis [{name}] on the stored JAX draws: max |Δ| patches "
                f"{errs[0]:.2e}, heatmaps {errs[1]:.2e}")
            require(max(errs) <= SYNTH_TOL, f"phase 13 synthesis [{name}] disagrees with JAX")
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {}
    for name, n in (("det_base", 32), ("det_diet", 32), ("frame_patch", 64), ("refine", 64)):
        synth = fixture_synthesizer(name, cfg, dev)
        ms[f"{name}@{n}"] = cuda_ms(lambda: synth.batch(gen, n), iters=10)
    log("phase 13 synthesis alone, ms per training batch (draws + render, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    out["ms_per_batch"] = ms
    return out


def three_steps(kind, fix, dev):
    """Three Adam steps from the shipped weights on the stored batch: the
    losses per step and the running statistics after them, against the
    stored JAX float32 values (largest relative loss error, largest
    statistics error of each layer's scale)."""
    import torch

    from deepcharuco_tpu_torch import weights as W
    from deepcharuco_tpu_torch.models import Detector, RefineNet
    from deepcharuco_tpu_torch.train import (create_detector_state, create_refinenet_state,
                                             make_detector_train_step,
                                             make_refinenet_train_step, state_variables)

    if kind == "det":
        model = W.load_state(Detector(N_IDS, torch.float32),
                             W.detector_state_dict(W.variables_from_npz(DET))).to(dev)
        state, step = create_detector_state(model, 1e-4), make_detector_train_step()
        cat = lambda k: np.concatenate([fix[f"synth/{n}/out/{k}"] for n in ("det_base",
                                                                          "det_diet")])
        batch = [torch.from_numpy(cat("images").astype(np.float32)),
                 torch.from_numpy(cat("loc")), torch.from_numpy(cat("ids"))]
        keys = ("loss", "loss_loc", "loss_ids")
    else:
        model = W.load_state(RefineNet(torch.float32),
                             W.refinenet_state_dict(W.variables_from_npz(RN))).to(dev)
        state, step = create_refinenet_state(model, 1e-4), make_refinenet_train_step()
        batch = [torch.from_numpy(fix[f"synth/refine/out/{k}"]) for k in ("patches", "heatmaps")]
        keys = ("loss",)
    batch = [b.to(dev) for b in batch]
    losses, rel = [], 0.0
    for i in range(3):
        state, aux = step(state, *batch)
        losses.append({k: float(aux[k]) for k in keys})
        for k in keys:
            want = float(fix[f"train/{kind}/{k}"][i])
            rel = max(rel, abs(losses[-1][k] - want) / abs(want))
    stats = W.flatten_variables({"batch_stats": state_variables(state)["batch_stats"]})
    stats_err = max(float(np.abs(v - fix[f"train/{kind}/{k}"]).max()
                          / np.abs(fix[f"train/{kind}/{k}"]).max()) for k, v in stats.items())
    return losses, rel, stats_err


def phase_train_steps(fix, dev):
    import torch

    out = {}
    for kind, name in (("det", "detector"), ("rn", "RefineNet")):
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            losses, rel, stats_err = three_steps(kind, fix, dev)
            out[f"{name}, tf32={tf32}"] = {"losses": losses, "max_rel_loss_err": rel,
                                           "max_stats_err": stats_err}
            log(f"phase 13 {name} 3 Adam steps (lr 1e-4) from the shipped weights on the stored "
                f"batch, TF32 {'on' if tf32 else 'off'}: losses "
                f"{[round(l['loss'], 8) for l in losses]} against JAX f32 "
                f"{[round(float(x), 8) for x in fix[f'train/{kind}/loss']]}, max relative error "
                f"{rel:.2e}; running statistics within {stats_err:.2e} of each layer's scale")
            if not tf32:
                require(rel <= STEP_REL, f"phase 13 {name} steps: losses disagree with JAX")
                require(stats_err <= STATS_TOL,
                        f"phase 13 {name} steps: running statistics disagree with JAX")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return out


def jsonl_rows(logdir):
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train_clis(cfg, fix, dev):
    """Both trainers through their CLIs at full width (cuDNN's default TF32
    convolutions, as a user runs them); the decode kernel's launches in the
    detector trainer's eval; a checkpoint served; a resumed run."""
    import shutil
    import tempfile

    import torch

    from deepcharuco_tpu_torch.cli import train as det_cli
    from deepcharuco_tpu_torch.cli import train_refinenet as rn_cli
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    torch.backends.cudnn.allow_tf32 = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        common = ["--device-synth", "--eval-every", "20", "--eval-batches", "2",
                  "--fused-steps", "4", "--ckpt-dir", os.path.join(tmp, "ck")]
        reset_launches()
        t0 = time.perf_counter()
        det_cli.main(common + ["--steps", "40", "--logdir", os.path.join(tmp, "tb")])
        wall = time.perf_counter() - t0
        launches = launch_counts()[0]
        rows = jsonl_rows(os.path.join(tmp, "tb"))
        with open(os.path.join(tmp, "ck", "index.json")) as f:
            index = json.load(f)
        log(f"phase 13 cli.train --device-synth --steps 40 --eval-every 20 --eval-batches 2 "
            f"--fused-steps 4 (batch {cfg.bs_train}, {cfg.input_hw[0]}×{cfg.input_hw[1]}): "
            f"{wall:.1f} s; "
            + "; ".join(f"step {r['step']}: train_loss {r['train_loss']:.4f} val_loss "
                        f"{r['val_loss']:.4f} match {r['val_match_ratio']:.3f} "
                        f"{r['steps_per_sec']:.2f} dispatches/s" for r in rows)
            + f"; checkpoints {sorted(index)}; decode kernel launches {launches}, fused "
            f"{launch_counts()[1]}")
        require([r["step"] for r in rows] == [20, 40], "cli.train logged the wrong steps")
        require(all(np.isfinite(r[k]) for r in rows for k in r), "cli.train: non-finite scalars")
        require(sorted(index) == ["step_0000080", "step_0000160"], "cli.train: checkpoints")
        require(launches == 4 and launch_counts()[1] == 0,
                f"cli.train eval launched the decode kernel {launches} times, expected 4")
        pipe = load_pipeline(cfg, os.path.join(tmp, "ck", "step_0000160", "variables.npz"), RN,
                             device=dev)
        kp, v, r = pipe.detect(fix["frames"])
        require(kp.shape == (8, N_IDS, 2) and np.isfinite(r).all(),
                "a trained checkpoint does not serve in InferencePipeline")
        log(f"phase 13 checkpoint step_0000160 served by InferencePipeline: "
            f"{int(v.sum())} corners on the 8 fixture frames")
        det_cli.main(common + ["--steps", "20", "--resume", "step_0000080", "--logdir",
                               os.path.join(tmp, "tb_resumed")])
        resumed = jsonl_rows(os.path.join(tmp, "tb_resumed"))[-1]
        d = abs(resumed["val_loss"] - rows[-1]["val_loss"]) / rows[-1]["val_loss"]
        log(f"phase 13 resumed at step_0000080 for 20 dispatches: val_loss "
            f"{resumed['val_loss']:.4f} against {rows[-1]['val_loss']:.4f} uninterrupted "
            f"(relative {d:.3f}; the resumed run trains on the feed's first batches again)")
        require(d <= RESUME_REL, "a resumed run did not reach the uninterrupted run's val_loss")
        t0 = time.perf_counter()
        rn_cli.main(["--device-synth", "--frame-patches", "--steps", "8", "--eval-every", "4",
                     "--eval-batches", "2", "--fused-steps", "2", "--init-npz", RN,
                     "--logdir", os.path.join(tmp, "tb_rn"), "--ckpt-dir",
                     os.path.join(tmp, "ck_rn")])
        rn_rows = jsonl_rows(os.path.join(tmp, "tb_rn"))
        rn_files = sorted(os.listdir(os.path.join(tmp, "ck_rn")))
        log(f"phase 13 cli.train_refinenet --device-synth --frame-patches --steps 8 "
            f"--fused-steps 2 (batch {cfg.bs_train_rn}): {time.perf_counter() - t0:.1f} s; "
            + "; ".join(f"step {r['step']}: loss {r['train_refinenet_loss']:.5f} val "
                        f"{r['val_refinenet_loss']:.5f}" for r in rn_rows)
            + f"; {rn_files}")
        require(len(rn_rows) == 2 and all(np.isfinite(r[k]) for r in rn_rows for k in r),
                "cli.train_refinenet: scalars")
        require(rn_files == ["index.json", "step_0000008", "step_0000016"],
                "cli.train_refinenet: checkpoints")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.allow_tf32 = False
    return {"det_rows": rows, "resumed_val_loss": resumed["val_loss"], "rn_rows": rn_rows,
            "det_wall_s": wall}, launches


def phase_train_measure(cfg, dev):
    """Train steps per second at batch 32 (synthesis + step), the step alone,
    peak memory, TF32 off and on; the step by device operation; B1's
    launches in one eval batch, counted by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepcharuco_tpu_torch.data import DeviceSynthesizer
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.parallel import synth_scan_program
    from deepcharuco_tpu_torch.train import (create_detector_state, flax_init_,
                                             make_detector_eval_step, make_detector_train_step)
    from deepcharuco_tpu_torch.train.metrics import detector_metrics

    bs = cfg.bs_train
    synth = DeviceSynthesizer(cfg, device=dev)
    state = create_detector_state(flax_init_(Detector(N_IDS, torch.float32)).to(dev))
    step = make_detector_train_step()
    program = synth_scan_program(step, lambda g: synth.batch(g, bs))
    gen = torch.Generator(device=dev).manual_seed(0)
    fixed = synth.batch(gen, bs)
    out = {}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        for _ in range(3):
            program(state, gen)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            state, aux = program(state, gen)
        float(aux["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        step_ms = cuda_ms(lambda: step(state, *fixed), iters=10, warmup=2)
        out[f"tf32={tf32}"] = {"steps_per_s": n / dt, "ms_per_step": 1e3 * dt / n,
                               "step_alone_ms": step_ms, "peak_gib": peak}
        log(f"phase 13 detector training at batch {bs}, 240×320, float32, TF32 "
            f"{'on' if tf32 else 'off'}: {n / dt:.2f} steps/s ({1e3 * dt / n:.3f} ms per "
            f"synthesis + step), the step alone on a fixed batch {step_ms:.3f} ms, peak "
            f"{peak:.2f} GiB above the model at rest")
    busy, span, n_ops = busy_share(lambda: [program(state, gen) for _ in range(5)])
    out["tf32=True"].update({"busy_ms": busy, "span_ms": span, "device_ops_5_steps": n_ops})
    log(f"phase 13 five synthesis + train steps (TF32 on) under torch.profiler: busy {busy:.3f} "
        f"of {span:.3f} ms (idle share {1 - busy / span:.4f}), {n_ops} device operations")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        program(state, gen)
        torch.cuda.synchronize()
    by_op = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    total_us = sum(e.device_time_total for e in by_op)
    out["by_op_ms"] = {e.key[:60]: e.device_time_total / 1e3 for e in by_op[:10]}
    log(f"phase 13 one synthesis + train step by device operation ({total_us / 1e3:.3f} ms, "
        "TF32 on): " + "; ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.2f} ms ×{e.count}"
                                 for e in by_op[:10]))
    eval_fn = make_detector_eval_step()
    vi, vl, vd = synth.batch(torch.Generator(device=dev).manual_seed(777), 16)

    def one_eval():
        aux_v, o = eval_fn(state, vi, vl, vd)
        return detector_metrics(o["loc"], o["ids"], vl, vd, N_IDS)

    one_eval()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_eval()
        torch.cuda.synchronize()
    n_b1 = sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "decode_kernel" in e.name)
    eval_ms = cuda_ms(one_eval, iters=5, warmup=1)
    log(f"phase 13 one eval batch of 16 (loss + detector_metrics): {eval_ms:.3f} ms; the "
        f"profiler sees {n_b1} launch(es) of B1 (decode_kernel)")
    require(n_b1 == 1, f"the eval batch launched B1 {n_b1} times in the profile, expected 1")
    out["eval_ms"] = eval_ms
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return out


def phase_train(cfg, fix, dev):
    out = {"synthesis": phase_synthesis(cfg, fix, dev), "steps": phase_train_steps(fix, dev)}
    out["clis"], launches = phase_train_clis(cfg, fix, dev)
    out["measure"] = phase_train_measure(cfg, dev)
    return out, launches


class Launches:
    """The kernels' launch counts over one entry point's run: set to 0 on
    entry, read on exit, added to ``total``."""

    def __init__(self, total: dict, runs: dict, name: str):
        self.total, self.runs, self.name = total, runs, name

    def __enter__(self):
        reset_launches()
        return self

    def __exit__(self, *exc):
        self.counts = launch_counts()
        self.runs[self.name] = self.counts
        self.total["decode"] += self.counts[0]
        self.total["fused_head_decode"] += self.counts[1]
        return False


BENCH_UNIQUE = 8        # unique resident batches per benchmark run


def phase_checkpoint_forms(cfg, fix, dev):
    """``load_pipeline`` from a Lightning ``.ckpt`` that the port wrote from
    the shipped weights and from a trainer checkpoint directory: ``detect``
    bit-equal to the ``.npz``-loaded pipeline."""
    import shutil
    import tempfile

    from deepcharuco_tpu_torch.compat import save_lightning_checkpoint
    from deepcharuco_tpu_torch.pipeline import load_pipeline
    from deepcharuco_tpu_torch.train.checkpoints import CheckpointManager
    from deepcharuco_tpu_torch.weights import variables_from_npz

    want = load_pipeline(cfg, DET, RN, device=dev).detect(fix["frames"])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        det_ckpt, rn_ckpt = os.path.join(tmp, "deepc.ckpt"), os.path.join(tmp, "refinenet.ckpt")
        save_lightning_checkpoint(det_ckpt, variables_from_npz(DET), "detector")
        save_lightning_checkpoint(rn_ckpt, variables_from_npz(RN), "refinenet")
        step_dir = CheckpointManager(os.path.join(tmp, "ck")).save(
            "step_0000001", variables_from_npz(DET), metric=0.0)
        for tag, det, rn in (("Lightning .ckpt files", det_ckpt, rn_ckpt),
                             ("a CheckpointManager directory", step_dir, RN)):
            got = load_pipeline(cfg, det, rn, device=dev).detect(fix["frames"])
            same = all(np.array_equal(a, b) for a, b in zip(got, want))
            log(f"phase 14 load_pipeline from {tag}: detect on the fixture frames bit-equal "
                f"to the .npz-loaded pipeline: {same}")
            require(same, f"load_pipeline from {tag} differs from the .npz weights")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_benchmark_cli(dev, yard, total, runs):
    """``cli.benchmark``'s core at batch 256 (64 under the tap), every path
    of its flags, each beside the earlier phase that times the same path."""
    import torch

    from deepcharuco_tpu_torch.cli import benchmark as bench_cli

    base = ["--deepc", DET, "--refinenet", RN, "--batch", str(N),
            "--iters", str(BENCH_UNIQUE), "--warmup", "2"]
    cases = [("two-stage", [], "detect"),
             ("--with-pose", ["--with-pose"], "pose"),
             ("--fused-head", ["--fused-head"], None),
             ("--breakdown", ["--breakdown"], "detect"),
             ("--multi-stream 256 --frames-per-stream 8",
              ["--multi-stream", str(N), "--frames-per-stream", "8"], "StreamServer"),
             ("--multi-stream 32 --stream-chunk 8",
              ["--multi-stream", "32", "--stream-chunk", "8"], "DeviceQueueServer"),
             ("--hires 2 --with-pose --rn-patch-size 32 --rn-decode soft --batch 64",
              ["--hires", "2", "--with-pose", "--rn-patch-size", "32", "--rn-decode", "soft",
               "--batch", "64", "--refinenet", RN32], "hires")]
    out = {}
    for name, flags, yard_key in cases:
        args = bench_cli.build_argparser().parse_args(base + flags)
        t0 = time.perf_counter()
        with Launches(total, runs, f"cli.benchmark {name}") as cnt:
            res = bench_cli.run(args)
        torch.cuda.empty_cache()
        res["wall_s"] = time.perf_counter() - t0
        out[name] = res
        beside = ""
        if yard_key is not None:
            yard_name, yard_value = yard[yard_key]
            mine = res["fps"] if "fps" in yard_name else res["ms_per_batch"]
            beside = f"; {yard_name} {yard_value:.3f} → this/that {mine / yard_value:.3f}"
        log(f"phase 14 cli.benchmark {name}: " + " | ".join(res["lines"])
            + f"{beside}; launches decode/fused {cnt.counts}; {res['wall_s']:.1f} s")
        require(cnt.counts[0] >= 1, f"cli.benchmark {name} did not launch the decode kernel")
        require(np.isfinite(res["fps"]) and res["fps"] > 0, f"cli.benchmark {name}: fps")
        if name == "--fused-head":
            require(cnt.counts[1] >= 1, "cli.benchmark --fused-head did not launch B2")
            require(res["agree_valid"] >= 0.98,
                    f"--fused-head agreement {res['agree_valid']:.4f} < 0.98")
    return out


def phase_bench_module():
    """``python -m deepcharuco_tpu_torch.bench`` in its own process: one JSON
    line with the protocol's keys, and a FLOP rate under the card's peak."""
    import re

    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "deepcharuco_tpu_torch.bench"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={k: v for k, v in os.environ.items() if not k.startswith("BENCH_")})
    wall = time.perf_counter() - t0
    for line in r.stderr.strip().splitlines():
        log(f"phase 14 bench (stderr): {line}")
    require(r.returncode == 0, f"python -m deepcharuco_tpu_torch.bench exited {r.returncode}")
    lines = r.stdout.strip().splitlines()
    require(len(lines) == 1, f"bench printed {len(lines)} lines on stdout, expected 1")
    rec = json.loads(lines[0])
    log(f"phase 14 bench line: {lines[0]} ({wall:.1f} s)")
    require(sorted(rec) == ["metric", "unit", "value", "vs_baseline"] and rec["value"] > 0,
            f"bench's line has the wrong keys or value: {rec}")
    m = re.search(r"([\d.]+) GFLOP/frame ⇒ ([\d.]+) TFLOP/s", r.stderr)
    require(m is not None, "bench printed no FLOP figure")
    require(float(m.group(2)) * 1e12 < PEAK_BF16,
            f"bench's implied {m.group(2)} TFLOP/s exceeds the card's peak")
    return {"line": rec, "gflop_per_frame": float(m.group(1)),
            "tflops": float(m.group(2)), "wall_s": wall}


def phase_infer_eval_pose(cfg, fix, dev, total, runs):
    """The cores of ``cli.infer``, ``cli.eval`` and ``cli.pose_video`` on the
    fixture, against the pipeline, the stored JAX values and the port's own
    plain versions."""
    import torch

    from deepcharuco_tpu_torch.cli import eval as eval_cli
    from deepcharuco_tpu_torch.cli.infer import infer_frames
    from deepcharuco_tpu_torch.cli.pose_video import estimate
    from deepcharuco_tpu_torch.pipeline import Camera, load_pipeline
    from deepcharuco_tpu_torch.pnp.ransac import (sample_weights,
                                                  solve_pnp_ransac_from_weights)
    from deepcharuco_tpu_torch.pose_filter import PoseFilter

    out = {}
    frames = fix["frames"]
    cam = Camera(K=fix["K"], dist=fix["dist"])
    pipe = load_pipeline(cfg, DET, RN, camera=cam, device=dev)

    # infer: the (x, y, id) rows of detect, held to the stored JAX bf16 outputs
    with Launches(total, runs, "cli.infer"):
        rows = infer_frames(pipe, frames)
    kp, v, r = pipe.detect(frames)
    same = all(np.array_equal(row[0], pipe.keypoint_array(r[i], v[i]))
               for i, row in enumerate(rows))
    log(f"phase 14 cli.infer core: rows equal keypoint_array(detect) on {len(rows)} frames: "
        f"{same}; launches decode/fused {runs['cli.infer']}")
    require(same and runs["cli.infer"][0] >= 1, "cli.infer's core differs from detect")
    corners_agree("phase 14 cli.infer core vs JAX bf16",
                  tuple(np.stack([row[j] for row in rows]) for j in (1, 2, 3)),
                  stored(fix, "bf16", POSE_KEYS[:3]))

    # eval: float32 (TF32 off) on the stored JAX renders against JAX's eval
    args = eval_cli.build_argparser().parse_args(["--deepc", DET, "--refinenet", RN])
    images = torch.from_numpy(fix["synth/det_base/out/images"].astype(np.float32)).to(dev)
    truth = (fix["synth/det_base/out/kpts"], fix["synth/det_base/out/visible"])
    forward = eval_cli.make_forward(args, cfg, dev)
    with Launches(total, runs, "cli.eval"):
        res = eval_cli.evaluate(forward, [(images, truth)], N_IDS, 3.0, "subpixel")
    jax_eval = {k: fix[f"eval/{k}"].item() for k in ("n_target", "n_pred", "n_matched",
                                                     "raw_mean", "refined_mean")}
    log(f"phase 14 cli.eval core (float32, TF32 off) on the stored JAX renders: "
        + ", ".join(f"{k} {res[k]} (JAX {jax_eval[k]})" for k in jax_eval)
        + f"; launches decode/fused {runs['cli.eval']}")
    require(res["n_target"] == jax_eval["n_target"], "eval: n_target differs from JAX's")
    require(all(abs(res[k] - jax_eval[k]) <= 2 for k in ("n_pred", "n_matched")),
            "eval: counts differ from JAX's by more than 2")
    require(all(abs(res[k] - jax_eval[k]) <= 0.01 for k in ("raw_mean", "refined_mean")),
            "eval: mean errors differ from JAX's by more than 0.01 px")
    require(runs["cli.eval"][0] >= 1, "cli.eval did not launch the decode kernel")
    out["eval"] = res

    # pose_video: plain, --smooth, --ransac
    want = pipe.detect_with_pose(frames)
    with Launches(total, runs, "cli.pose_video"):
        got = list(estimate(pipe, [frames[:5], frames[5:]]))
    same = all(np.array_equal(np.asarray(g[j]), want[j][i]) for i, g in enumerate(got)
               for j in range(6))
    log(f"phase 14 cli.pose_video core: equal to detect_with_pose on {len(got)} frames: {same}; "
        f"launches decode/fused {runs['cli.pose_video']}")
    require(same and runs["cli.pose_video"][0] >= 1, "pose_video's core differs")
    gate_t = 10.0 * cfg.square_len
    smooth = list(estimate(pipe, [frames], pose_filter=PoseFilter(gate_t=gate_t)))
    ref = PoseFilter(gate_t=gate_t)
    same = True
    for i, g in enumerate(smooth):
        o, rv, tv, _ = ref.update(bool(want[3][i]), want[4][i].astype(np.float64),
                                  want[5][i].astype(np.float64))
        same &= g[3] == o and np.array_equal(g[4], rv) and np.array_equal(g[5], tv)
    log(f"phase 14 cli.pose_video --smooth: equal to PoseFilter on detect_with_pose: {same}")
    require(same, "pose_video --smooth differs from the pose filter")
    robust = list(estimate(pipe, [frames], cam, ransac=True))
    ok, rvec, tvec = (np.stack([g[j] for g in robust]) for j in (3, 4, 5))
    # the same subsets (a generator on the card seeded 0) scored on the CPU
    weights = sample_weights(torch.as_tensor(want[1]).to(dev), 16,
                             generator=torch.Generator(device=dev).manual_seed(0))
    to = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    cpu = solve_pnp_ransac_from_weights(pipe.object_points.cpu(), to(want[2]),
                                        torch.as_tensor(want[1]), to(cam.K), to(cam.dist),
                                        weights.cpu())
    ok_c, rvec_c, tvec_c = (t.numpy() for t in cpu[:3])
    held = ok & ok_c
    d_r = np.abs(rvec - rvec_c).max(-1)
    with np.errstate(invalid="ignore", divide="ignore"):     # frames not solved: inf
        d_t = np.linalg.norm(tvec - tvec_c, axis=-1) / np.linalg.norm(tvec_c, axis=-1)
    near_ls = want[3] & ok & (np.abs(rvec - want[4]).max(-1) <= 0.02)
    log(f"phase 14 cli.pose_video --ransac (16 hypotheses from a generator on the card seeded "
        f"0) against the port's RANSAC on the CPU on the same subsets: ok {ok.astype(int)} vs "
        f"{ok_c.astype(int)}; on {int(held.sum())} frames held max |Δrvec| "
        f"{d_r[held].max(initial=0):.2e} rad, max |Δtvec|/|tvec| {d_t[held].max(initial=0):.2e}; "
        f"within 0.02 rad of the least-squares pose on {int(near_ls.sum())} of "
        f"{int(want[3].sum())} frames")
    require(int((ok != ok_c).sum()) <= 1, "pose_video --ransac: ok differs from the CPU's")
    require(d_r[held].max(initial=0) <= 0.02 and d_t[held].max(initial=0) <= 0.02,
            "pose_video --ransac: pose differs from the CPU's on the same subsets")
    out["ransac"] = {"ok": ok.tolist(), "near_least_squares": int(near_ls.sum())}
    return out


def phase_entry_points(cfg, fix, dev, yard):
    """14. The entry points users run, each through its core on the card."""
    t0 = time.perf_counter()
    total = {"decode": 0, "fused_head_decode": 0}
    runs = {}
    phase_checkpoint_forms(cfg, fix, dev)
    out = {"benchmark": phase_benchmark_cli(dev, yard, total, runs),
           "bench": phase_bench_module()}
    out.update(phase_infer_eval_pose(cfg, fix, dev, total, runs))
    out["launches"] = runs
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 14 launches on the entry points: {total} ({out['wall_s']:.1f} s)")
    return out, total


# --- 15. the host data pipeline -------------------------------------------------

HOST_NATIVE_SHARE = 0.001   # native route: share of pixels that may differ (a level)
HOST_NUMPY_SHARE = 0.01     # numpy route: share of pixels that may differ ...
HOST_NUMPY_LEVELS = 2       # ... each by at most this many levels


def host_fixture_agreement(fix) -> dict:
    """The port's host pipeline against the JAX package's samples stored in
    the fixture (``host/...``): both routes of ``CharucoDataset`` and
    ``RefineNetDataset`` (validation streams) and ``make_background_bank(8)``.
    Labels and RefineNet corners must be equal; images may differ where the
    native core's floating point does (a level on at most 0.1% of pixels)
    and, on the numpy route, on at most 1% of pixels by at most 2 levels.
    Runs on the CPU as well (the tests call it)."""
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.data import CharucoDataset, RefineNetDataset, make_background_bank

    cfg = default_config()
    gray = lambda img: np.rint(img * 255.0 + 128.0).astype(np.uint8)[..., 0]
    out = {}
    for route in ("native", "numpy"):
        native = route == "native"
        det = CharucoDataset(cfg, validation=True, use_native=native)
        items = [det[i] for i in range(4)]
        for k in ("loc", "ids"):
            require(np.array_equal(np.stack([it[k] for it in items]),
                                   fix[f"host/det_{route}/{k}"]),
                    f"host CharucoDataset ({route}): {k} differs from the JAX package's")
        d_det = np.abs(np.stack([gray(it["image"]) for it in items]).astype(int)
                       - fix[f"host/det_{route}/gray"])
        rn = RefineNetDataset(cfg, validation=True, use_native=native)
        items = [rn[i] for i in range(2)]
        corners = np.array([[np.unravel_index(np.argmax(h[..., 0]), h.shape[:2])[::-1]
                             for h in it["heatmaps"]] for it in items])
        require(np.array_equal(corners, fix[f"host/rn_{route}/corners"]),
                f"host RefineNetDataset ({route}): corners differ from the JAX package's")
        d_rn = np.abs(np.stack([gray(it["patches"]) for it in items]).astype(int)
                      - fix[f"host/rn_{route}/gray"])
        for name, d in (("detector images", d_det), ("RefineNet patches", d_rn)):
            share = float((d > 0).mean())
            out[f"{route} {name}"] = {"share": share, "max_levels": int(d.max())}
            if native:
                require(share <= HOST_NATIVE_SHARE and d.max() <= 1,
                        f"host {name} (native): {share:.2e} of pixels differ, up to {d.max()}")
            else:
                require(share <= HOST_NUMPY_SHARE and d.max() <= HOST_NUMPY_LEVELS,
                        f"host {name} (numpy): {share:.2e} of pixels differ, up to {d.max()}")
    d = np.abs(make_background_bank(8).astype(int) - fix["host/bank"])
    out["bank"] = {"share": float((d > 0).mean()), "max_levels": int(d.max())}
    require(out["bank"]["share"] <= HOST_NATIVE_SHARE and d.max() <= 1,
            f"make_background_bank(8): {out['bank']} against the JAX package's")
    return out


def host_rate(dataset, batch: int, workers: int) -> float:
    """Samples per second of ``dataset`` through a fresh ``BatchLoader`` with
    ``workers`` threads: 3·workers + 1 batches from the start of the threads
    (so that the queue's first batches, made in parallel, are a small part)."""
    from deepcharuco_tpu_torch.data import BatchLoader

    n = 3 * workers + 1
    t0 = time.perf_counter()
    loader = BatchLoader(dataset, batch, num_workers=workers, seed=0, max_batches=n)
    try:
        for _ in loader:
            pass
    finally:
        loader.stop()
    return n * batch / (time.perf_counter() - t0)


def phase_host_clis(cfg, dev):
    """Both trainers and the evaluation on the host stream through their
    CLIs at full width; B1's launches counted over them."""
    import shutil
    import tempfile

    import torch

    from deepcharuco_tpu_torch.cli import eval as eval_cli
    from deepcharuco_tpu_torch.cli import quantize as quant_cli
    from deepcharuco_tpu_torch.cli import train as det_cli
    from deepcharuco_tpu_torch.cli import train_refinenet as rn_cli
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    torch.backends.cudnn.allow_tf32 = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    out = {}
    try:
        reset_launches()
        runs = {
            "host": ["--steps", "6", "--eval-every", "3", "--eval-host-batches", "2"],
            "mixed": ["--device-synth", "--bg-bank", "8", "--mixed-host-every", "3",
                      "--steps", "6", "--eval-every", "3", "--eval-host-batches", "2"]}
        for name, flags in runs.items():
            t0 = time.perf_counter()
            det_cli.main(flags + ["--eval-batches", "2", "--logdir", os.path.join(tmp, name),
                                  "--ckpt-dir", os.path.join(tmp, f"ck_{name}")])
            rows = jsonl_rows(os.path.join(tmp, name))
            out[f"train {name}"] = {"wall_s": time.perf_counter() - t0, "rows": rows}
            log(f"phase 15 cli.train {' '.join(flags)} (batch {cfg.bs_train}): "
                f"{time.perf_counter() - t0:.1f} s; "
                + "; ".join(f"step {r['step']}: train_loss {r['train_loss']:.4f} val_loss "
                            f"{r['val_loss']:.4f}"
                            + (f" val_host_loss {r['val_host_loss']:.4f} host_match "
                               f"{r['val_host_match_ratio']:.3f}" if "val_host_loss" in r
                               else "") for r in rows))
            require([r["step"] for r in rows] == [3, 6], f"cli.train ({name}) logged wrong steps")
            require(all(np.isfinite(r[k]) for r in rows for k in r),
                    f"cli.train ({name}): non-finite scalars")
        require(all("val_host_loss" in r for r in out["train mixed"]["rows"]),
                "cli.train --eval-host-batches logged no val_host_* scalars")
        t0 = time.perf_counter()
        rn_cli.main(["--steps", "4", "--eval-every", "2", "--eval-batches", "2",
                     "--init-npz", RN, "--logdir", os.path.join(tmp, "rn"),
                     "--ckpt-dir", os.path.join(tmp, "ck_rn")])
        rn_rows = jsonl_rows(os.path.join(tmp, "rn"))
        log(f"phase 15 cli.train_refinenet on the host stream (batch {cfg.bs_train_rn}: "
            f"{cfg.bs_train_rn // 8} images × 8 patches): {time.perf_counter() - t0:.1f} s; "
            + "; ".join(f"step {r['step']}: loss {r['train_refinenet_loss']:.5f} val "
                        f"{r['val_refinenet_loss']:.5f}" for r in rn_rows))
        require(len(rn_rows) == 2 and all(np.isfinite(r[k]) for r in rn_rows for k in r),
                "cli.train_refinenet on the host stream: scalars")
        out["train_refinenet host"] = rn_rows
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        res = eval_cli.main(["--source", "host", "--samples", "64", "--deepc", DET,
                             "--refinenet", RN])
        log(f"phase 15 cli.eval --source host --samples 64 (shipped weights, float32): "
            f"{time.perf_counter() - t0:.1f} s; {res}")
        require(res["samples"] == 64 and res["n_target"] > 0 and res["raw_mean"] is not None
                and np.isfinite(res["refined_mean"]), "cli.eval --source host")
        out["eval host"] = res
        launches = launch_counts()[0]
        log(f"phase 15 B1 launches on the host-fed paths: {launches}")
        # one per eval batch: host run 2 evals × 2, mixed run 2 × (2 + 2 host), eval 4
        require(launches == 4 + 8 + 4, f"B1 launched {launches} times on the host paths, "
                "expected 16")
        t0 = time.perf_counter()
        q = quant_cli.main([DET, "--out", os.path.join(tmp, "int8.npz")])
        pipe = load_pipeline(cfg, os.path.join(tmp, "int8.npz"), RN, device=dev)
        log(f"phase 15 cli.quantize (64 calibration, 32 eval boards on the card): "
            f"{time.perf_counter() - t0:.1f} s; {q}; serves as {type(pipe.detector).__name__}")
        require(q["detections_int8"] > 0 and type(pipe.detector).__name__ == "QuantDetector",
                "cli.quantize: the artifact does not serve as the int8 detector")
        out["quantize"] = q
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.allow_tf32 = False
    return out, launches


def phase_host_measure(cfg, dev):
    """Host samples/s of both datasets by thread count; host-fed training
    steps/s beside on-card synthesis in the same call, the card's idle share
    under host-fed training, the mixed diet's cost; a 64-image bank's build."""
    import torch

    from deepcharuco_tpu_torch.data import (BatchLoader, CharucoDataset, DeviceSynthesizer,
                                            RefineNetDataset, device_prefetch,
                                            make_background_bank)
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.parallel import synth_scan_program
    from deepcharuco_tpu_torch.train import (create_detector_state, flax_init_,
                                             make_detector_train_step)

    out = {"cpu_count": os.cpu_count(), "num_workers": cfg.num_workers}
    threads = sorted({1, 2, 4, cfg.num_workers})
    for name, make, batch in (("CharucoDataset", lambda: CharucoDataset(cfg), cfg.bs_train),
                              ("RefineNetDataset", lambda: RefineNetDataset(cfg),
                               cfg.bs_train_rn // 8)):
        rates = {w: host_rate(make(), batch, w) for w in threads}
        out[f"{name} samples_per_s"] = rates
        log(f"phase 15 {name} through BatchLoader (batch {batch}), samples/s by threads "
            f"({os.cpu_count()} CPUs): " + ", ".join(f"{w}: {r:.1f}" for w, r in rates.items()))

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    bs = cfg.bs_train
    state = create_detector_state(flax_init_(Detector(cfg.n_ids, torch.float32)).to(dev))
    step = make_detector_train_step()
    synth = DeviceSynthesizer(cfg, device=dev)
    program = synth_scan_program(step, lambda g: synth.batch(g, bs))
    gen = torch.Generator(device=dev).manual_seed(0)
    loaders = []

    def fresh_feed():
        loaders.append(BatchLoader(CharucoDataset(cfg), bs, num_workers=cfg.num_workers,
                                   seed=0))
        return device_prefetch(loaders[-1], size=2, device=dev)

    def run(n, feed=None, every=0):
        """n dispatches: host batches from ``feed`` (every ``every``-th one
        with ``every``), else on-card synthesis; the last loss."""
        nonlocal state
        for i in range(n):
            if feed is not None and (every == 0 or (i + 1) % every == 0):
                b = next(feed)
                state, aux = step(state, b["image"], b["loc"], b["ids"])
            else:
                state, aux = program(state, gen)
        return float(aux["loss"])

    def rate(n, warm, **kw):
        # warm-up first: it also drains what the threads made before the steps began
        run(warm, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = run(n, **kw)
        torch.cuda.synchronize()
        require(np.isfinite(loss), "non-finite training loss")
        return n / (time.perf_counter() - t0)

    try:
        sps = {"device-synth": rate(40, 5)}
        feed = fresh_feed()
        sps["host"] = rate(16, 8, feed=feed)
        busy, span, n_ops = busy_share(lambda: run(8, feed=feed))
        loaders.pop().stop()
        sps["mixed every 3"] = rate(24, 9, feed=fresh_feed(), every=3)
        loaders.pop().stop()
        sps["device-synth again"] = rate(40, 5)
        out["steps_per_s"] = sps
        out["host_fed_idle_share"] = 1 - busy / span
        log(f"phase 15 detector training at batch {bs}, TF32 on, steps/s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sps.items())
            + f"; host-fed, 8 steps under the profiler: the card busy {busy:.1f} of "
              f"{span:.1f} ms (idle share {1 - busy / span:.4f}, {n_ops} device operations)")
    finally:
        for loader in loaders:
            loader.stop()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    bank = make_background_bank(64)
    out["bank64_s"] = time.perf_counter() - t0
    log(f"phase 15 make_background_bank(64) (procedural, native): {out['bank64_s']:.2f} s, "
        f"{bank.nbytes / 2 ** 20:.1f} MiB")
    return out


def phase_host(cfg, fix, dev):
    """15. The host data pipeline: the native core's build, agreement with
    the stored JAX samples, the host-fed CLIs, the measurements."""
    from deepcharuco_tpu_torch.data import native

    t0 = time.perf_counter()
    native.load()
    out = {"native_build_s": time.perf_counter() - t0}
    log(f"phase 15 native core: {native.lib_path().name} in {out['native_build_s']:.1f} s")
    out["agreement"] = host_fixture_agreement(fix)
    log(f"phase 15 host pipeline against the stored JAX samples: {out['agreement']}")
    out["clis"], launches = phase_host_clis(cfg, dev)
    out["measure"] = phase_host_measure(cfg, dev)
    return out, launches


# Phase 16: the card's --charuco calibration is held to the JAX CLI's stored
# result (bf16 networks on both sides; the CPU route is within 0.031% of fx
# and 0.09 px of cx/cy, tests/test_torch_calib.py) and to the true camera.
CALIB_SHARE = 2e-3          # fx, fy against JAX's stored K, relative
CALIB_C_PX = 0.5            # cx, cy against JAX's stored K, px
CALIB_ERR_PX = 0.02         # mean reprojection error against JAX's, px
CHESS_SUBPIX = 0.01         # chessboard corners against cv2's stored ones, px
TILTED_SHARE = 3e-5         # chessboard K on the tilted views against JAX's, of fx


def _true_camera_limits(tag, K, K_true):
    """``tests/test_charuco_calib.py:138-141``: fx, fy within 1.5%, cx, cy
    within 4 px of the camera that rendered the views."""
    ok = all(abs(K[i, i] - K_true[i, i]) / K_true[i, i] < 0.015
             and abs(K[i, 2] - K_true[i, 2]) < 4.0 for i in (0, 1))
    require(ok, f"{tag}: K {K[[0, 1, 0, 1], [0, 1, 2, 2]]} outside the test's limits of "
                f"the true camera")


def phase_calib(cfg, fix, dev, tmp):
    """The calibration CLI's ``--charuco`` core, the CLI itself on PNGs the
    port wrote, and its chessboard mode, without cv2."""
    from deepcharuco_tpu_torch import calib
    from deepcharuco_tpu_torch.cli import calib_intrinsics as calib_cli
    from deepcharuco_tpu_torch.data import cvnp, png

    out, launches = {}, {}
    K_true = fix["calib/K_true"]
    for name, key in (("clean", "calib/views"), ("clean again", "calib/views"),
                      ("dark", "calib/dark")):
        ref = name.split()[0]
        reset_launches()
        timings = {}
        t0 = time.perf_counter()
        K, dist, err, used = calib_cli.charuco_calibrate(
            fix[key], cfg, DET, RN32, verbose=False, device=dev, timings=timings)
        wall = time.perf_counter() - t0
        launches[f"charuco_calibrate {name}"] = launch_counts()[0]
        K_jax = fix[f"calib/{ref}/K"]
        share = max(abs(K[i, i] - K_jax[i, i]) / K_jax[i, i] for i in (0, 1))
        c_px = max(abs(K[i, 2] - K_jax[i, 2]) for i in (0, 1))
        n = len(fix[key])
        out[f"charuco {name}"] = {
            "K": K[[0, 1, 0, 1], [0, 1, 2, 2]].tolist(), "dist": dist.ravel().tolist(),
            "err_px": float(err), "views_used": int(used),
            "jax_err_px": float(fix[f"calib/{ref}/err"]),
            "jax_views_used": int(fix[f"calib/{ref}/used"]), "fxfy_share_vs_jax": float(share),
            "cxcy_px_vs_jax": float(c_px), "detect_ms_per_view": 1e3 * timings["detect_s"] / n,
            "solve_ms": 1e3 * timings["solve_s"], "wall_s": wall,
            "b1_launches": launch_counts()[0]}
        log(f"phase 16 charuco_calibrate ({name}, {n} views of {fix[key].shape[1]}x"
            f"{fix[key].shape[2]}, 32-px RefineNet, avg, bf16, batch 16): {used} views, "
            f"K {np.round(K[[0, 1, 0, 1], [0, 1, 2, 2]], 3).tolist()}, error {err:.4f} px "
            f"(JAX {float(fix[f'calib/{ref}/err']):.4f} px, {int(fix[f'calib/{ref}/used'])} "
            f"views); fx/fy {share:.2e} and cx/cy {c_px:.3f} px from JAX's K; detection "
            f"{1e3 * timings['detect_s'] / n:.2f} ms per view, solver "
            f"{1e3 * timings['solve_s']:.1f} ms, {wall:.2f} s in all; B1 launches "
            f"{launch_counts()[0]}")
        if dev.type == "cuda":
            require(launch_counts()[0] >= 1, f"charuco_calibrate ({name}) did not launch B1")
        if ref == "clean":
            _true_camera_limits(f"charuco_calibrate ({name})", K, K_true)
            require(used == int(fix["calib/clean/used"]), "views used differ from JAX's")
            require(share <= CALIB_SHARE and c_px <= CALIB_C_PX,
                    f"charuco_calibrate: K {share:.2e} / {c_px:.3f} px from JAX's")
            require(abs(err - float(fix["calib/clean/err"])) <= CALIB_ERR_PX,
                    "charuco_calibrate: reprojection error differs from JAX's")
            K_clean = K
        else:       # tests/test_charuco_calib.py:170-173
            require(used >= 9 and err < 0.6 and all(
                abs(K[i, i] - K_true[i, i]) / K_true[i, i] < 0.015 for i in (0, 1)),
                f"low-light calibration: {used} views, error {err:.3f}, K {K}")

    # the CLI on PNGs that the port wrote
    views = os.path.join(tmp, "views")
    os.makedirs(views)
    for i, f in enumerate(fix["calib/views"]):
        png.write_png(os.path.join(views, f"v_{i:03d}.png"), f)
    reset_launches()
    t0 = time.perf_counter()
    calib_cli.main([views, "--charuco", "--deepc", DET, "--refinenet", RN32, "--out",
                    os.path.join(tmp, "cam.npz")] + ([] if dev.type == "cuda" else
                                                      ["--device", str(dev)]))
    wall = time.perf_counter() - t0
    launches["cli.calib_intrinsics --charuco"] = launch_counts()[0]
    with np.load(os.path.join(tmp, "cam.npz")) as z:
        K_cli = z["camera_matrix"]
    gap = float(np.abs(K_cli - K_clean).max() / K_clean[0, 0])
    log(f"phase 16 cli.calib_intrinsics --charuco on the port's PNGs: {wall:.2f} s; "
        f"camera_params.npz K {gap:.2e} of fx from the charuco_calibrate call's "
        f"(bit-equal: {gap == 0.0}); B1 launches {launch_counts()[0]}")
    require(gap <= 1e-6, "the CLI's camera_params.npz differs from charuco_calibrate's")
    out["cli charuco"] = {"wall_s": wall, "K_gap": gap, "b1_launches": launch_counts()[0]}

    for name in ("chess", "tilted"):
        frames = fix[f"calib/{name}/frames"]
        d = os.path.join(tmp, name)
        os.makedirs(d)
        worst, found = 0.0, 0
        for i, (g, want) in enumerate(zip(frames, fix[f"calib/{name}/corners"])):
            png.write_png(os.path.join(d, f"c_{i:03d}.png"), np.repeat(g[..., None], 3, -1))
            ok, pts = calib.find_chessboard_corners(g, (9, 6))
            found += ok
            if ok:
                got = cvnp.corner_sub_pix(g, pts, 11, 30, 0.001).reshape(-1, 2)
                worst = max(worst, min(np.abs(got - want).max(),
                                       np.abs(got[::-1] - want).max()))
        t0 = time.perf_counter()
        calib_cli.main([d, "--stride", "1", "--out", os.path.join(d, "cam.npz")]
                       + ([] if dev.type == "cuda" else ["--device", str(dev)]))
        wall = time.perf_counter() - t0
        with np.load(os.path.join(d, "cam.npz")) as z:
            K = z["camera_matrix"]
        K_jax = fix[f"calib/{name}/K"]
        gap = float(np.abs(K - K_jax).max() / K_jax[0, 0])
        log(f"phase 16 cli.calib_intrinsics chessboard ({name}, {len(frames)} frames of "
            f"480x640, no cv2): found on {found}/{len(frames)}, corners within "
            f"{worst:.5f} px of cv2's, K {np.round(K[[0, 1, 0, 1], [0, 1, 2, 2]], 3).tolist()}"
            f" ({gap:.2e} of JAX's fx from JAX's), {wall:.2f} s")
        require(found == len(frames) and worst <= CHESS_SUBPIX,
                f"chessboard ({name}): found {found}, corners {worst} px from cv2's")
        if name == "tilted":
            require(gap <= TILTED_SHARE, f"chessboard K {gap:.2e} of fx from JAX's")
        out[f"cli chessboard {name}"] = {"wall_s": wall, "found": int(found),
                                         "corner_px": float(worst), "K_gap_vs_jax": gap}
    return out, launches


def phase_view(cfg, dev, tmp):
    """``cli.view`` in its three modes, one page each: the page read back
    equals the grid drawn; the predictions page equals ``detect`` drawn."""
    from deepcharuco_tpu_torch import board as B
    from deepcharuco_tpu_torch.cli import view as view_cli
    from deepcharuco_tpu_torch.data import CharucoDataset, png
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    out, launches = {}, {}
    drawn = []
    tile = view_cli._tile
    view_cli._tile = lambda cells, cols: drawn.append(tile(cells, cols)) or drawn[-1]
    try:
        for what in ("dataset", "refine", "predictions"):
            reset_launches()
            t0 = time.perf_counter()
            paths = view_cli.main(["--what", what, "--pages", "1", "--validation", "--deepc",
                                   DET, "--refinenet", RN, "--out", os.path.join(tmp, what)]
                                  + ([] if dev.type == "cuda" else ["--device", str(dev)]))
            wall = time.perf_counter() - t0
            page = png.read_png(paths[0])
            same = np.array_equal(page, drawn[-1])
            launches[f"cli.view {what}"] = launch_counts()[0]
            out[what] = {"wall_s": wall, "page_shape": list(page.shape),
                         "b1_launches": launch_counts()[0]}
            log(f"phase 16 cli.view --what {what} (16 per page, no cv2): {wall:.2f} s per "
                f"page, {page.shape[1]}x{page.shape[0]} page read back equal to the grid: "
                f"{same}; B1 launches {launch_counts()[0]}")
            require(same, f"cli.view {what}: the page read back differs from the grid drawn")
    finally:
        view_cli._tile = tile
    if dev.type == "cuda":
        require(launches["cli.view predictions"] >= 1, "cli.view predictions did not launch B1")
    ds = CharucoDataset(cfg, validation=True)
    samples = [ds[i] for i in range(16)]
    frames = np.stack([view_cli._denorm(s["image"]) for s in samples])
    pipe = load_pipeline(cfg, DET, RN, device=dev)
    _, valid, refined = pipe.detect(frames)
    cells = []
    for img, s, v, r in zip(frames, samples, valid, refined):
        kp, ok = view_cli._truth(s, cfg.n_ids)
        img = B.draw_keypoints_with_validity(img, kp, ok, color=(0, 255, 0))
        cells.append(B.draw_keypoints_with_validity(img, r, v, color=(255, 0, 255)))
    same = np.array_equal(drawn[-1], view_cli._tile(cells, 4))
    log(f"phase 16 cli.view predictions page equals detect on the same 16 frames, drawn: "
        f"{same} ({int(valid.sum())} corners)")
    require(same, "cli.view predictions: the page differs from detect's corners drawn")
    return out, launches


def phase_calib_view(cfg, fix, dev):
    """16. Camera calibration and the grid viewer (no cv2 on the card's
    machine); B1's launches on each path."""
    import importlib.util
    import shutil
    import tempfile

    log(f"phase 16 cv2 importable: {importlib.util.find_spec('cv2') is not None} (the phase "
        "blocks it either way)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_calib_")
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None           # the whole phase runs as if cv2 were not installed
    try:
        t0 = time.perf_counter()
        calib_out, launches = phase_calib(cfg, fix, dev, tmp)
        view_out, view_launches = phase_view(cfg, dev, tmp)
        launches.update(view_launches)
        out = {"calib": calib_out, "view": view_out, "b1_launches": launches,
               "phase_s": time.perf_counter() - t0}
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 16 B1 launches by path: {launches}; {out['phase_s']:.1f} s")
    return out, sum(launches.values())


# ---------------------------------------------------------------------------
# 17. Several ranks: the mesh at world size 1 under NCCL, two ranks under gloo
# ---------------------------------------------------------------------------

# Two ranks against one process (`cli.train`, 4 steps from the shipped weights
# on the same global batch, bit for bit, lr 1e-4, TF32 off). A sound mesh
# differs from one process only in the order of float32 sums (BatchNorm's mean
# of the ranks' means, the gradient summed over ranks, convolutions on
# 120-row halves whose cuDNN algorithm may differ). Two readings, each with
# its limit between the sound runs' largest reading and the smallest reading
# of a planted fault (`scripts/probe_torch_parallel_faults.py`, PERF.md):
# train_loss per logged step, relative; and the last checkpoint's parameters
# against one process's, root mean square in units of lr, leaving out the
# convolution biases that feed a BatchNorm (their gradient is zero up to
# rounding, and Adam turns that rounding into steps of up to lr of its own).
# On an NVIDIA H100 80GB HBM3 at 700 W the sound 2x1 and 1x2 runs read at most
# 1.43e-6 and 0.0044 lr; with the gradient average left out or per-rank
# BatchNorm statistics, at least 4.5e-3 and 0.75 lr.
PARALLEL_LOSS_REL = 1e-5
PARALLEL_PARAM_RMS_LR = 0.05
PARALLEL_STEPS = 4
PARALLEL_LR = 1e-4
PARALLEL_TRAIN = ["--device-synth", "--init-npz", DET, "--lr", str(PARALLEL_LR),
                  "--batch-size", "32", "--steps", str(PARALLEL_STEPS), "--eval-every", "1",
                  "--eval-batches", "1"]
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT")


def _sync_ms(fn, iters: int = 5) -> float:
    """Host ms per call of ``fn``, the card synchronised around the run."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def _detector_f32(dev):
    import torch

    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.weights import (detector_state_dict, load_state,
                                               variables_from_npz)

    det = Detector(N_IDS, torch.float32)
    return load_state(det, detector_state_dict(variables_from_npz(DET))).to(dev)


def _inference_fns(pipes, fix, dev):
    """name → fn(det, rn, frames) for phase 17's sharded inference."""
    from deepcharuco_tpu_torch.board import inner_corner_object_points
    from deepcharuco_tpu_torch.pipeline import full_forward, two_stage_forward

    folded = pipes["fused"].folded
    obj = inner_corner_object_points(5, 5, 0.01)
    K, dist = fix["K"], fix["dist"]
    return {
        "two_stage": lambda d, r, x: two_stage_forward(d, r, x, N_IDS, device=dev),
        "two_stage fused": lambda d, r, x: two_stage_forward(d, r, x, N_IDS, fused_head=True,
                                                             folded=folded, device=dev),
        "full_forward": lambda d, r, x: full_forward(d, r, x, N_IDS, obj, K, dist,
                                                     device=dev),
        "full_forward fused": lambda d, r, x: full_forward(d, r, x, N_IDS, obj, K, dist,
                                                           fused_head=True, folded=folded,
                                                           device=dev)}


def phase_parallel_world1(cfg, fix, dev, pipes, batch):
    """17a. World size 1 under NCCL in this process (a file store): sharded
    inference and three sharded train steps bit-equal to the plain calls,
    every collective launched (at one rank NCCL's sum is the identity)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from deepcharuco_tpu_torch.data import DeviceSynthesizer
    from deepcharuco_tpu_torch.parallel import (init_distributed, make_mesh, shard_batch,
                                                sharded_inference, sharded_train_step)
    from deepcharuco_tpu_torch.train import create_detector_state, make_detector_train_step

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    saved = {k: os.environ.pop(k) for k in DIST_ENV if k in os.environ}
    out, launches = {}, {"decode": 0, "fused_head_decode": 0}
    try:
        init_distributed(init_method=f"file://{os.path.join(tmp, 'store')}")
        require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"phase 17 world 1: backend {dist.get_backend()}")
        mesh = make_mesh(1, 1)
        det, rn = pipes["heads+decode"].detector, pipes["heads+decode"].refinenet
        for name, fn in _inference_fns(pipes, fix, dev).items():
            run = sharded_inference(fn, mesh)
            for tag, frames in (("fixture", fix["frames"]), (f"batch of {N}", batch)):
                want = fn(det, rn, frames)
                reset_launches()
                got = run(det, rn, frames)
                torch.cuda.synchronize()
                counts = launch_counts()
                launches["decode"] += counts[0]
                launches["fused_head_decode"] += counts[1]
                same = _same(got, want)
                log(f"phase 17 world 1 (NCCL) sharded_inference [{name}] on the {tag}: "
                    f"bit-equal to the call without a mesh: {same}; B1/B2 launches {counts}")
                require(same, f"phase 17 world 1 [{name}, {tag}]: differs from the plain call")
                require(counts == ((0, 1) if "fused" in name else (1, 0)),
                        f"phase 17 world 1 [{name}]: kernel launches {counts}")
            if name in ("two_stage", "two_stage fused"):
                ms = _sync_ms(lambda: run(det, rn, batch))
                plain = _sync_ms(lambda: fn(det, rn, batch))
                out[f"{name} ms_per_batch"] = {"mesh": ms, "plain": plain}
                log(f"phase 17 world 1 [{name}]: {ms:.3f} ms per batch of {N} on the mesh, "
                    f"{plain:.3f} without")

        torch.backends.cudnn.deterministic = True
        synth = DeviceSynthesizer(cfg, device=dev)
        images, loc, ids = synth.batch(torch.Generator(device=dev).manual_seed(5), 32)

        def three(step, batch_):
            state = create_detector_state(_detector_f32(dev), 5e-3)
            losses = []
            for _ in range(3):
                state, aux = step(state, *batch_)
                losses.append(aux["loss"].clone())
            return losses, [t.clone() for t in state.model.state_dict().values()], state

        plain_step = make_detector_train_step()
        mesh_step = sharded_train_step(plain_step, mesh)
        ref = three(plain_step, (images, loc, ids))
        again = three(plain_step, (images, loc, ids))
        got = three(mesh_step, shard_batch(mesh, (images, loc, ids)))
        # the state must be bit-equal; the loss scalar too where the plain step
        # gives the same bits twice (CUDA's 2-d NLL loss sums blocks atomically)
        deterministic = _same(ref[1], again[1])
        loss_bits = _same(ref[0], again[0])
        same = _same(ref[1], got[1])
        same_loss = _same(ref[0], got[0])
        loss_rel = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(got[0], ref[0]))
        log(f"phase 17 world 1 (NCCL): 3 sharded_train_steps (batch 32, 240x320, TF32 off, "
            f"cuDNN deterministic) against the plain step: parameters and running "
            f"statistics bit-equal {same}, losses bit-equal {same_loss} (relative "
            f"{loss_rel:.2e}); the plain step twice: state {deterministic}, losses "
            f"{loss_bits}; losses {[round(float(x), 6) for x in got[0]]}")
        require(deterministic, "phase 17 world 1: the plain step is not deterministic")
        require(same, "phase 17 world 1: the sharded step differs from the plain step")
        require(same_loss if loss_bits else loss_rel <= 1e-6,
                "phase 17 world 1: the sharded step's losses differ from the plain step's")
        out.update(state_bit_equal=same, loss_bit_equal=same_loss, loss_rel=loss_rel)
        state = got[2]
        step_ms = _sync_ms(lambda: mesh_step(state, images, loc, ids))
        plain_ms = _sync_ms(lambda: plain_step(state, images, loc, ids))
        out["step_ms"] = {"mesh": step_ms, "plain": plain_ms}
        log(f"phase 17 world 1 (NCCL): {step_ms:.3f} ms per step on the mesh, {plain_ms:.3f} "
            f"without (batch 32, TF32 off)")
    finally:
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()
        os.environ.update(saved)
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    return out, launches


def checkpoint_gap(got_dir, want_dir, lr):
    """Two detector checkpoints apart: the parameters' largest |Δ| and root
    mean square |Δ| in units of ``lr``, over every weight but the
    convolution biases that feed a BatchNorm; the running statistics'
    largest |Δ| relative to each tensor's largest value."""
    with np.load(os.path.join(got_dir, "variables.npz")) as a, \
            np.load(os.path.join(want_dir, "variables.npz")) as b:
        d = {k: np.abs(a[k].astype(np.float64) - b[k]) for k in b.files}
        scale = {k: float(np.abs(b[k]).max()) for k in b.files}
    weights = np.concatenate([v.ravel() for k, v in d.items()
                              if k.startswith("params/") and not k.endswith("/conv/bias")])
    return {"max_lr": float(weights.max() / lr),
            "rms_lr": float(np.sqrt(np.mean(weights ** 2)) / lr),
            "stats_rel": max(float(v.max()) / scale[k] for k, v in d.items()
                             if k.startswith("batch_stats/"))}


def loss_gap(got, want):
    """The largest relative train_loss difference over the logged steps."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _run(cmd, tag, env, timeout=600):
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        log(run.stdout[-4000:])
        log(run.stderr[-4000:])
    require(run.returncode == 0, f"phase 17 {tag}: exit code {run.returncode}")
    return run, wall


def _torchrun(n):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n)]


def parallel_cli_run(tmp, tag, launch, extra, env):
    """``cli.train`` with phase 17's arguments and ``extra``, started by
    ``launch`` (the command up to the trainer's arguments) → (train_loss by
    logged step, the last checkpoint's directory, the run, its wall s)."""
    d = os.path.join(tmp, tag.replace(" ", "_"))
    run, wall = _run(launch + PARALLEL_TRAIN + extra
                     + ["--logdir", os.path.join(d, "tb"), "--ckpt-dir", os.path.join(d, "ck")],
                     f"cli.train [{tag}]", env)
    rows = jsonl_rows(os.path.join(d, "tb"))
    require([r["step"] for r in rows] == list(range(1, PARALLEL_STEPS + 1)),
            f"phase 17 cli.train [{tag}]: logged steps {[r['step'] for r in rows]}")
    return ([r["train_loss"] for r in rows],
            os.path.join(d, "ck", f"step_{PARALLEL_STEPS:07d}"), run, wall)


def parallel_env():
    """The environment of phase 17's ranks: no rank variables of this
    process, TF32 off, the checkout importable."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env.update(NVIDIA_TF32_OVERRIDE="0", PYTHONPATH=ROOT)
    return env


def phase_parallel_ranks(cfg, fix, dev, pipes, batch):
    """17b. Two ranks on the one card under gloo: the trainer through
    torchrun against one process at the same seed, rank 0's checkpoint
    served; then ``chip_smoke.py --ranks`` in two ranks (sharded inference
    on 2×1 and 1×2 meshes, steps/s, peak memory, collective share)."""
    import shutil
    import tempfile

    import torch

    from deepcharuco_tpu_torch.pipeline import load_pipeline

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    env = parallel_env()
    out = {}
    try:
        losses, cks = {}, {}
        cli = ["-m", "deepcharuco_tpu_torch.cli.train"]
        for tag, launch, extra in (
                ("one process", [sys.executable] + cli, []),
                ("2 ranks 2x1", _torchrun(2) + cli, ["--data-parallel"]),
                ("2 ranks 1x2", _torchrun(2) + cli, ["--data-parallel", "--mesh-spatial", "2"])):
            losses[tag], cks[tag], run, wall = parallel_cli_run(tmp, tag, launch, extra, env)
            backends = sorted({line.split("backend ")[1].split(",")[0]
                               for line in run.stdout.splitlines() if "backend " in line})
            log(f"phase 17 cli.train [{tag}] (batch 32, --init-npz, lr {PARALLEL_LR}, TF32 "
                f"off): {wall:.1f} s, backends {backends}; train_loss by step "
                f"{[round(x, 6) for x in losses[tag]]}")
            if extra:
                require(backends == ["gloo"], f"phase 17 [{tag}]: backends {backends}")
                require(run.stdout.count("best checkpoint:") == 1,
                        f"phase 17 [{tag}]: more than rank 0 reported a checkpoint")
                rel = loss_gap(losses[tag], losses["one process"])
                gap = checkpoint_gap(cks[tag], cks["one process"], PARALLEL_LR)
                out[f"cli {tag} max_rel_loss"] = rel
                out[f"cli {tag} checkpoint_gap"] = gap
                log(f"phase 17 cli.train [{tag}] against one process: train_loss within "
                    f"{rel:.3e} relative (limit {PARALLEL_LOSS_REL}); rank 0's last "
                    f"checkpoint's parameters {gap['rms_lr']:.3e} lr apart, root mean square "
                    f"(limit {PARALLEL_PARAM_RMS_LR}), largest {gap['max_lr']:.3e} lr; "
                    f"running statistics within {gap['stats_rel']:.3e} relative")
                require(rel <= PARALLEL_LOSS_REL, f"phase 17 [{tag}]: losses disagree")
                require(gap["rms_lr"] <= PARALLEL_PARAM_RMS_LR,
                        f"phase 17 [{tag}]: the trained parameters disagree")
            out[f"cli {tag} wall_s"] = wall
        out["cli_losses"] = losses
        kp, v, r = load_pipeline(cfg, cks["2 ranks 1x2"], RN, device=dev).detect(fix["frames"])
        require(kp.shape == (8, N_IDS, 2) and np.isfinite(r).all(),
                "phase 17: rank 0's checkpoint does not serve")
        log(f"phase 17 rank 0's checkpoint step_{PARALLEL_STEPS:07d} (1x2 mesh) served by "
            f"InferencePipeline: {int(v.sum())} corners on the 8 fixture frames")

        np.save(os.path.join(tmp, "batch.npy"), batch)
        run, wall = _run(_torchrun(2) + [os.path.join(ROOT, "chip_smoke.py"), "--ranks", tmp],
                         "chip_smoke.py --ranks", env)
        for line in run.stdout.splitlines():
            if line.startswith("phase 17"):
                log(line)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
            log(f"phase 17 2 ranks: rank {r}'s B1/B2 launches in its 4 sharded inference "
                f"calls {ranks[r]['launches']}")
        for name, pipe in pipes.items():
            kp, v, r = (torch.from_numpy(a) for a in pipe.detect(batch))
            for layout in ("2x1", "1x2"):
                with np.load(os.path.join(tmp, f"infer_{layout}_{name}.npz")) as z:
                    gk, gv, gr = (torch.from_numpy(z[k]) for k in ("kp", "valid", "refined"))
                slot, coord = mismatch(gk, gv, kp, v)
                agree = gv & v & ((gk - kp).abs().amax(-1) == 0)
                near = float(((gr - r).abs().amax(-1) <= 0.125)[agree].float().mean())
                out[f"infer {layout} {name}"] = {"slot": slot, "coord": coord, "near": near}
                log(f"phase 17 2 ranks sharded_inference [{name}] on {layout} against one "
                    f"card, batch of {N}: slot mismatch {slot:.4f}, coord mismatch "
                    f"{coord:.4f}, |Δrefined|≤0.125 on {near:.4f} of {int(agree.sum())}")
                require(slot <= 0.02 and coord <= 0.02 and near >= 0.98,
                        f"phase 17 2 ranks [{name}, {layout}] disagree with one card")
        out["ranks"] = ranks
        out["ranks wall_s"] = wall
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"decode": sum(r["launches"]["decode"] for r in ranks),
                "fused_head_decode": sum(r["launches"]["fused_head_decode"] for r in ranks)}
    return out, launches


def ranks_worker(tmp) -> int:
    """One rank of ``chip_smoke.py --ranks DIR`` under torchrun (two ranks on
    one card, gloo): the collectives on CUDA tensors, sharded inference of
    the batch in ``DIR/batch.npy`` on 2×1 and 1×2 meshes (rank 0 writes the
    outputs), sharded train steps per mesh (steps/s, peak memory, the
    collectives' share of a step), B1/B2 launches; ``DIR/rank<r>.json``."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from deepcharuco_tpu_torch import _build
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.data import DeviceSynthesizer
    from deepcharuco_tpu_torch.parallel import (init_distributed, make_mesh,
                                                sharded_inference, sharded_train_step)
    from deepcharuco_tpu_torch.pipeline import InferencePipeline, two_stage_forward
    from deepcharuco_tpu_torch.train import (create_detector_state,
                                             make_detector_train_step)
    from deepcharuco_tpu_torch.weights import variables_from_npz

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed()
    rank = dist.get_rank()
    _build.build()
    x = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    parts = [torch.empty(2, device=dev) for _ in range(2)]
    dist.all_gather(parts, torch.full((2,), float(rank), device=dev))
    b = torch.full((3,), float(rank + 5), device=dev)
    dist.broadcast(b, 0)
    ok = (bool((x == 3).all()) and [float(p[0]) for p in parts] == [0.0, 1.0]
          and bool((b == 5).all()))
    if rank == 0:
        log(f"phase 17 gloo on CUDA tensors, 2 ranks sharing {torch.cuda.get_device_name(0)}: "
            f"all_reduce, all_gather, broadcast right: {ok}")
    require(ok, "gloo collectives on CUDA tensors")

    cfg = default_config()
    dv, rv = variables_from_npz(DET), variables_from_npz(RN)
    pipes = {"heads+decode": InferencePipeline(cfg, dv, rv, device=dev),
             "fused": InferencePipeline(cfg, dv, rv, fused_head=True, device=dev)}
    batch = np.load(os.path.join(tmp, "batch.npy"))
    report = {"launches": {"decode": 0, "fused_head_decode": 0}}
    synth = DeviceSynthesizer(cfg, device=dev)
    for layout in ((2, 1), (1, 2)):
        mesh = make_mesh(*layout, device=dev)
        tag = f"{layout[0]}x{layout[1]}"
        for name, pipe in pipes.items():
            fn = lambda d, r, x, p=pipe: two_stage_forward(
                d, r, x, N_IDS, fused_head=p.fused_head, folded=p.folded, device=dev)
            run = sharded_inference(fn, mesh)
            run(pipe.detector, pipe.refinenet, batch)            # warm-up
            torch.cuda.synchronize()
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            kp, valid, refined = run(pipe.detector, pipe.refinenet, batch)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            counts = {"decode": launch_counts()[0], "fused_head_decode": launch_counts()[1]}
            for k, v in counts.items():
                report["launches"][k] += v
            report[f"infer {tag} {name}"] = {"ms": ms, "launches": counts}
            if rank == 0:
                np.savez(os.path.join(tmp, f"infer_{tag}_{name}.npz"), kp=kp.cpu().numpy(),
                         valid=valid.cpu().numpy(), refined=refined.cpu().numpy())
                log(f"phase 17 2 ranks sharded_inference [{name}] {tag}: {ms:.1f} ms for a "
                    f"batch of {N} (two ranks sharing one card); B1/B2 launches on rank 0 "
                    f"{counts}")
            require(counts["decode" if name == "heads+decode" else "fused_head_decode"] == 1,
                    f"2 ranks [{name}, {tag}]: kernel launches {counts}")

        state = create_detector_state(_detector_f32(dev), 1e-4)
        step = sharded_train_step(make_detector_train_step(), mesh)
        gen = torch.Generator(device=dev).manual_seed(7)
        share = (mesh.coords[0], mesh.shape["data"])
        data = synth.batch(gen, 32, share=share)
        for _ in range(2):
            state, aux = step(state, *data)
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        steps = 5
        t0 = time.perf_counter()
        for _ in range(steps):
            state, aux = step(state, *data)
        torch.cuda.synchronize()
        sps = steps / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, aux = step(state, *data)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        spans = {}
        for e in prof.events():
            if e.name.startswith("parallel.") and e.device_type == DeviceType.CPU:
                spans[e.name] = spans.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        share_coll = sum(spans.values()) / wall
        local = make_detector_train_step()                  # the same shard, no collectives
        dist.barrier()
        local_ms = _sync_ms(lambda: local(state, *data))
        report[f"train {tag}"] = {"steps_per_s": sps, "peak_gib": peak, "step_ms": wall,
                                  "collective_span_ms": spans, "collective_share": share_coll,
                                  "local_step_ms": local_ms, "loss": float(aux["loss"])}
        log(f"phase 17 2 ranks train {tag} rank {rank} (two ranks sharing one card, not a "
            f"scaling figure): {sps:.2f} steps/s of the global batch 32, peak "
            f"{peak:.2f} GiB; profiled step {wall:.1f} ms, collective spans "
            f"{ {k: round(v, 2) for k, v in spans.items()} } ms = {share_coll:.3f} of it; "
            f"the same shard's step without collectives {local_ms:.1f} ms")
        dist.barrier()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_parallel(cfg, fix, dev, pipes, batch):
    """17. Several ranks (the port's ``parallel.mesh``)."""
    t0 = time.perf_counter()
    world1, l1 = phase_parallel_world1(cfg, fix, dev, pipes, batch)
    ranks, l2 = phase_parallel_ranks(cfg, fix, dev, pipes, batch)
    launches = {k: l1[k] + l2[k] for k in l1}
    out = {"world1": world1, "ranks": ranks, "launches": launches,
           "phase_s": time.perf_counter() - t0}
    log(f"phase 17 B1/B2 launches on the sharded paths: world 1 {l1}, two ranks {l2}; "
        f"{out['phase_s']:.1f} s")
    return out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from deepcharuco_tpu_torch import _build
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline
    from deepcharuco_tpu_torch.weights import variables_from_npz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = smi()
    log(f"phase 1 card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("TF32 off for cuDNN convolutions and float32 matmuls (exact f32 references)")
    build_s = _build.build()
    log(f"phase 1 build: {build_s:.1f} s for {', '.join(_build.KERNELS)}")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas [{name}]: {line.strip()}")

    rng = np.random.default_rng(0)
    fix = dict(np.load(FIXTURE))
    cfg = default_config()
    dv, rv = variables_from_npz(DET), variables_from_npz(RN)
    cam = Camera(K=fix["K"], dist=fix["dist"])
    pipes = {"heads+decode": InferencePipeline(cfg, dv, rv, camera=cam, device=dev),
             "fused": InferencePipeline(cfg, dv, rv, camera=cam, fused_head=True,
                                        device=dev)}
    folded = pipes["fused"].folded

    dec_err = phase_decode(rng, dev)
    fused_err, fused_rates = phase_fused(rng, dev, pipes["fused"].detector, folded,
                                         fix["frames"])
    phase_main_path(pipes, fix)
    serve, launches, batch = phase_serve(pipes, fix["frames"], rng)
    rows, yard = phase_timing(dev, pipes, batch, folded, launches,
                              {"decode": dec_err, "fused_head_decode": fused_err})
    epilogue = phase_epilogue(pipes, launches)
    epilogue_no_norm = phase_epilogue_no_norm(dev)
    phase_pose_fixture(pipes, fix, dev)
    hi_pipe = phase_variants(cfg, dv, rv, fix, dev)
    pose, pose_launches = phase_pose_serve(pipes, hi_pipe, fix, rng, dev, serve)
    geom, geom_pipes = phase_geom(cfg, pipes, fix, rng, dev)
    int8, int8_launches = phase_int8(cfg, pipes, fix, rng, dev)
    streams, stream_launches = phase_streams(pipes, geom_pipes, fix, rng, dev)
    train, train_launches = phase_train(cfg, fix, dev)
    no_pose = streams["heads+decode, no pose"]["fps"]
    entry, entry_launches = phase_entry_points(cfg, fix, dev, {
        "detect": ("phase 5 ms/batch", serve["heads+decode"]["ms_per_batch"]),
        "pose": ("phase 9 ms/batch", pose["serve"]["heads+decode"]["ms_per_batch"]),
        "StreamServer": ("phase 12 StreamServer fps", max(no_pose["StreamServer"])),
        "DeviceQueueServer": ("phase 12 DeviceQueueServer fps",
                              max(no_pose["DeviceQueueServer"])),
        "hires": ("phase 9 hi-res ms/batch of 64", min(pose["hires"]["with_pose_ms"]))})
    host, host_launches = phase_host(cfg, fix, dev)
    calib_view, calib_launches = phase_calib_view(cfg, fix, dev)
    parallel, parallel_launches = phase_parallel(cfg, fix, dev, pipes, batch)
    for i, row in enumerate(rows):
        row["launches_pose_path"] = pose_launches[row["name"]]
        row["launches_int8_path"] = int8_launches if row["name"] == "decode" else 0
        row["launches_served_paths"] = sum(v[i] for v in stream_launches.values())
        row["launches_train_eval"] = train_launches if row["name"] == "decode" else 0
        row["launches_entry_points"] = entry_launches[row["name"]]
        row["launches_host_paths"] = host_launches if row["name"] == "decode" else 0
        row["launches_calib_view_paths"] = calib_launches if row["name"] == "decode" else 0
        row["launches_parallel_paths"] = parallel_launches[row["name"]]
    log(json.dumps({"serve": serve, "fused_mismatch": fused_rates, "yardsticks": yard,
                    "build_s": build_s, "pose": pose, "geom": geom, "int8": int8,
                    "streams": streams, "train": train, "entry_points": entry,
                    "host": host, "calib_view": calib_view, "parallel": parallel}))
    k256, k56 = pose["tail"][f"kernel_{N}"], pose["tail"]["kernel_56"]
    pnp_row = {"name": "pnp", "route": "cuda", "source": "deepcharuco_tpu_torch/csrc/pnp.cu",
               "replaces": None, "launches": pose_launches["pnp"],
               "ms": k256["device_ms"], "plain_ms": k256["plain_device_ms"],
               "bound_ms": k256["bound_ms"], "bound_by": k256["bound_by"], "library_ms": None,
               "host_ms": k256["host_ms"], "device_launches_per_call": k256["device_ops"],
               "n56_ms": k56["device_ms"], "n56_plain_ms": k56["plain_device_ms"],
               "n56_bound_ms": k56["bound_ms"], "n56_host_ms": k56["host_ms"],
               "launches_served_paths": sum(v[2] for v in stream_launches.values())}
    log(smi())
    log(json.dumps({"kernels": rows + [epilogue, epilogue_no_norm, pnp_row]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--ranks"]:
            sys.exit(ranks_worker(sys.argv[2]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
