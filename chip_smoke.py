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
   3×3 convolution to 512 channels;
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
   runs the tail eagerly and must give identical outputs; then the pose tail
   alone on one batch's corners, run eagerly and replayed from the
   pipeline's CUDA graph (host ms to enqueue, ms to finish, device
   operations and their summed device time from ``torch.profiler``); one
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
    (two batches are in flight, so the pose graph's shared output buffers
    would show here if they were read late); fps beside the synchronous
    loop's, and the card's idle share under both from ``torch.profiler``
    (the union of the device operations' intervals over their span); the
    kernels' launch counts on the served paths; the geometry decode served
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
    CPU on the same subsets, within phase 7's limits).

Its last lines are the ``nvidia-smi`` name and power limit, one JSON object
with the kernels' numbers, and ``{"ok": true, "device": {...}}``. Imports
nothing of JAX. Run from anywhere: ``python3 chip_smoke.py``.
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

    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused

    frames = fix["frames"]
    ref_kp, ref_v, ref_r = (torch.from_numpy(fix[f"{k}_bf16"])
                            for k in ("keypoints", "valid", "refined"))
    for name, pipe in pipes.items():
        cuda_decode.launches = cuda_fused.launches = 0
        kp, v, r = (torch.from_numpy(a) for a in pipe.detect(frames))
        slot, coord = mismatch(kp, v, ref_kp, ref_v)
        agree = v & ref_v & ((kp - ref_kp).abs().amax(-1) == 0)
        near = float(((r - ref_r).abs().amax(-1) <= 0.125)[agree].float().mean())
        counts = (cuda_decode.launches, cuda_fused.launches)
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

    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused

    requests = 8
    batches = make_batches(frames, requests * len(pipes), rng)
    for pipe in pipes.values():          # warm-up: cuDNN plans, allocator
        pipe.detect(batches[0])
    torch.cuda.synchronize()
    cuda_decode.launches = cuda_fused.launches = 0
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
    launches = {"decode": cuda_decode.launches, "fused_head_decode": cuda_fused.launches}
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
    saved = (cuda_decode.launches, cuda_fused.launches)
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
    cuda_decode.launches, cuda_fused.launches = saved
    return rows, yard


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

    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
    from deepcharuco_tpu_torch.pipeline import Camera
    from deepcharuco_tpu_torch.pnp import solve_pnp_batch

    ref = stored(fix, "bf16")
    for name, pipe in pipes.items():
        cuda_decode.launches = cuda_fused.launches = 0
        out = pipe.detect_with_pose(fix["frames"])
        counts = (cuda_decode.launches, cuda_fused.launches)
        require(len(out) == 7, f"[{name}] detect_with_pose returned {len(out)} arrays")
        good = corners_agree(f"phase 7 pose path [{name}] vs JAX bf16", out, ref)
        pose_agrees(f"phase 7 pose path [{name}] vs JAX bf16", out, ref, good)
        want = (1, 0) if name == "heads+decode" else (0, 1)
        require(counts == want, f"[{name}] kernel launches {counts}, expected {want}")
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

    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused, extract_patches
    from deepcharuco_tpu_torch.pipeline import full_forward, two_stage_forward
    from deepcharuco_tpu_torch.pnp import solve_pnp_batch

    requests = 8
    batches = make_batches(fix["frames"], requests * len(pipes), rng)
    for pipe in pipes.values():          # warm-up: the pose tail's graph is captured here
        pipe.detect_with_pose(batches[0])
    torch.cuda.synchronize()
    cuda_decode.launches = cuda_fused.launches = 0
    pose = {}
    for i, (name, pipe) in enumerate(pipes.items()):
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
    launches = {"decode": cuda_decode.launches, "fused_head_decode": cuda_fused.launches}
    log(f"phase 9 launches on the pose path: {launches}")
    require(all(v >= requests for v in launches.values()),
            f"a kernel of the pose path was not launched: {launches}")

    # the same path with the tail run eagerly: the functional entry point
    pipe = pipes["heads+decode"]
    eager_path = lambda b: tuple(t.cpu().numpy() for t in full_forward(
        pipe.detector, pipe.refinenet, b, N_IDS, pipe.object_points, fix["K"], fix["dist"],
        device=dev))
    same = all(np.array_equal(a, b, equal_nan=True) for a, b in
               zip(eager_path(batches[0]), pipe.detect_with_pose(batches[0])))
    require(same, "full_forward (eager tail) and detect_with_pose (graph) differ")
    t0 = time.perf_counter()
    for b in batches[:4]:
        eager_path(b)
    eager_ms = 1e3 * (time.perf_counter() - t0) / 4
    pose["heads+decode"]["eager_tail_ms_per_batch"] = eager_ms
    log(f"phase 9 serve pose [heads+decode] through full_forward, the tail run eagerly: "
        f"{eager_ms:.3f} ms/batch over 4 requests, outputs identical to the graph's")

    # the pose tail alone, on one batch's corners
    _, v, r = two_stage_forward(pipe.detector, pipe.refinenet, batches[0], N_IDS, device=dev)
    r, v = r.float().clone(), v.clone()
    K, dist = (torch.from_numpy(fix[k]).to(dev) for k in ("K", "dist"))
    eager = lambda: solve_pnp_batch(pipe.object_points, r, v, K, dist)
    graph = lambda: pipe.solve_pose(r, v)
    tail = {}
    for tag, fn in (("eager", eager), ("graph", graph)):
        fn()
        host, wall = host_and_wall_ms(fn)
        ops, busy = device_ops(fn)
        tail[tag] = {"host_ms": host, "wall_ms": wall, "device_ops": ops,
                     "device_busy_ms": busy}
        log(f"phase 9 pose tail [{tag}], batch {N}: host {host:.3f} ms to enqueue, "
            f"{wall:.3f} ms to finish, {ops} device operations, {busy:.3f} ms summed "
            f"device time")
    a, b = [t.clone() for t in eager()], graph()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"phase 9 pose tail: graph replay bit-identical to eager: {same}; "
        f"ok on {int(a[0].sum())} of {N}")
    require(all(torch.allclose(x.float(), y.float(), atol=1e-6, equal_nan=True)
                for x, y in zip(a, b)), "the pose tail's graph disagrees with eager")
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

    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
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
            cuda_decode.launches = cuda_fused.launches = 0
            out = pipe.detect_with_pose(frames)
            require((cuda_decode.launches, cuda_fused.launches) == (0, 0),
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
    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
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
    cuda_decode.launches = cuda_fused.launches = 0
    out = pipe.detect(fix["frames"])
    require((cuda_decode.launches, cuda_fused.launches) == (1, 0),
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
            cuda_decode.launches = 0
            ms[name].append(ms_per_batch(p.detect, batches[1:]))
            launches += cuda_decode.launches if name == "int8" else 0
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
    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
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
            cuda_decode.launches = cuda_fused.launches = 0
            got = {k: run() for k, run in runs.items()}     # also the warm-up
            launches[tag] = (cuda_decode.launches, cuda_fused.launches)
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
                f"launches decode/fused {launches[tag]}")
            want_l = (3 * steps, 0) if name == "heads+decode" else (0, 3 * steps)
            require(launches[tag] == want_l, f"[{tag}] kernel launches {launches[tag]}")
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
        stream_server_equal(tag, runs["StreamServer"](), want, RESULT_KEYS)
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
    from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
    from deepcharuco_tpu_torch.pipeline import load_pipeline

    torch.backends.cudnn.allow_tf32 = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        common = ["--device-synth", "--eval-every", "20", "--eval-batches", "2",
                  "--fused-steps", "4", "--ckpt-dir", os.path.join(tmp, "ck")]
        cuda_decode.launches = cuda_fused.launches = 0
        t0 = time.perf_counter()
        det_cli.main(common + ["--steps", "40", "--logdir", os.path.join(tmp, "tb")])
        wall = time.perf_counter() - t0
        launches = cuda_decode.launches
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
            f"{cuda_fused.launches}")
        require([r["step"] for r in rows] == [20, 40], "cli.train logged the wrong steps")
        require(all(np.isfinite(r[k]) for r in rows for k in r), "cli.train: non-finite scalars")
        require(sorted(index) == ["step_0000080", "step_0000160"], "cli.train: checkpoints")
        require(launches == 4 and cuda_fused.launches == 0,
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
        from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused

        cuda_decode.launches = cuda_fused.launches = 0
        return self

    def __exit__(self, *exc):
        from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused

        self.counts = (cuda_decode.launches, cuda_fused.launches)
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
    for i, row in enumerate(rows):
        row["launches_pose_path"] = pose_launches[row["name"]]
        row["launches_int8_path"] = int8_launches if row["name"] == "decode" else 0
        row["launches_served_paths"] = sum(v[i] for v in stream_launches.values())
        row["launches_train_eval"] = train_launches if row["name"] == "decode" else 0
        row["launches_entry_points"] = entry_launches[row["name"]]
    log(json.dumps({"serve": serve, "fused_mismatch": fused_rates, "yardsticks": yard,
                    "build_s": build_s, "pose": pose, "geom": geom, "int8": int8,
                    "streams": streams, "train": train, "entry_points": entry}))
    log(smi())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
