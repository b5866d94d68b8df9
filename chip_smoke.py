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
   tap's sizes.

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
    for row in rows:
        row["launches_pose_path"] = pose_launches[row["name"]]
    log(json.dumps({"serve": serve, "fused_mismatch": fused_rates, "yardsticks": yard,
                    "build_s": build_s, "pose": pose}))
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
