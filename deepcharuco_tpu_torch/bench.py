"""Benchmark harness: the full two-stage pipeline's frames per second at
320×240 on one card (the root ``bench.py``'s protocol, for the port).

Run: ``python -m deepcharuco_tpu_torch.bench``. The timed program is
``InferencePipeline.forward_device`` of the shipped weights: uint8 gray
frames in; normalization, detector, the decode kernel, the patch gather,
RefineNet and the sub-pixel corners out, all on the device.

Protocol:

1. **Every batch has its own content**: the board render pasted on gray
   90, each frame rolled by its own shift, under its own ±25-level noise.
   ``BENCH_UNIQUE`` batches (default ``BENCH_ITERS``) are made and uploaded
   before the timing, and the upload's rate is reported apart.
2. **Completion is the result on the host.** Two batches are in flight and
   every batch's refined corners are copied to the host, into pinned memory
   on the compute stream behind the batch (``serving._Lane``), and summed;
   the number of distinct sums is reported.
3. **FLOP check**: the convolutions and matrix products of one frame,
   counted by ``torch.utils.flop_counter.FlopCounterMode`` on the unfused
   route (the decode kernel does no matrix work and is not counted), times
   the frame rate must stay under the H100's dense bf16 peak, 989 TFLOP/s;
   a figure over it is declared not defensible.

``BENCH_COMPUTE=1`` also times ``BENCH_SCAN_ITERS`` (10) batches made from
one resident batch on the device under fresh noise, back to back with one
fetch at the end, and prints the share of the peak. Details go to stderr;
stdout carries one JSON line, ``{"metric", "value", "unit",
"vs_baseline"}``, where ``vs_baseline`` is against the reference's >200 fps
on a GTX 1080 Ti. ``BENCH_BATCH`` (256), ``BENCH_ITERS`` (16) and
``BENCH_DEVICE`` (default the card; ``cpu`` runs the plain versions) set the
rest.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import numpy as np

H100_BF16_PEAK_FLOPS = 989e12
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def flops_per_frame(pipe, frame) -> float:
    """FLOPs (2 per multiply-accumulate) of the convolutions and matrix
    products of one frame through the pipeline's detector, its heads and
    RefineNet (``torch.utils.flop_counter``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from deepcharuco_tpu_torch.pipeline import two_stage_forward

    x = torch.from_numpy(np.ascontiguousarray(frame[None])).to(pipe.device)
    with FlopCounterMode(display=False) as counter:
        two_stage_forward(pipe.detector, pipe.refinenet, x, pipe.n_ids, device=pipe.device)
    return float(counter.get_total_flops())


def main():
    import torch

    from deepcharuco_tpu_torch._device import resolve_device
    from deepcharuco_tpu_torch.board import rendered_board
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.pipeline import InferencePipeline, load_model_variables
    from deepcharuco_tpu_torch.serving import _Lane

    dev = resolve_device(os.environ.get("BENCH_DEVICE") or None)
    batch = int(os.environ.get("BENCH_BATCH", "256"))
    iters = int(os.environ.get("BENCH_ITERS", "16"))
    n_unique = int(os.environ.get("BENCH_UNIQUE", str(iters)))
    measure_compute = os.environ.get("BENCH_COMPUTE", "0") == "1"
    warmup, depth = 3, 2

    cfg = default_config()
    have = os.path.isfile(DET) and os.path.isfile(RN)     # else seeded weights
    pipe = InferencePipeline(cfg, load_model_variables(DET if have else None, "detector",
                                                       cfg.n_ids),
                             load_model_variables(RN if have else None, "refinenet"),
                             device=dev)
    _log(f"device {dev}; weights: {'shipped' if have else 'seeded random'}")

    gray_board, _ = rendered_board(cfg, 240)
    gray = np.full((240, 320), 90, np.uint8)
    gray[:, 40:280] = gray_board
    rng = np.random.default_rng(7)

    def make_batch(tag: int) -> np.ndarray:
        shifts = rng.integers(0, 32, size=(batch,))
        b = np.stack([np.roll(gray, int(s) + tag, axis=1) for s in shifts])
        noise = rng.integers(-25, 26, size=b.shape, dtype=np.int16)
        return np.clip(b.astype(np.int16) + noise, 0, 255).astype(np.uint8)

    host_batches = [make_batch(i) for i in range(n_unique)]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    xs = [torch.from_numpy(b).to(dev) for b in host_batches]
    sync()
    dt_up = time.perf_counter() - t0
    nbytes = sum(b.nbytes for b in host_batches)
    _log(f"host→device upload (pageable): {nbytes / 2**20:.0f} MiB in {dt_up:.3f}s "
         f"= {nbytes / 2**30 / dt_up:.3f} GB/s")

    lane = _Lane(dev, depth)
    fn = lambda x: (pipe.forward_device(x)[2],)
    for _ in range(warmup):
        lane.fetch(lane.download(fn(xs[0])))
    sync()
    q: collections.deque = collections.deque()
    checks = []
    t0 = time.perf_counter()
    for i in range(iters):
        q.append(lane.download(fn(xs[i % n_unique])))
        if len(q) > depth:
            checks.append(float(lane.fetch(q.popleft())[0].sum()))
    while q:
        checks.append(float(lane.fetch(q.popleft())[0].sum()))
    dt = time.perf_counter() - t0
    fps = batch * iters / dt
    _log(f"pipelined (depth {depth}, results fetched): {fps:.1f} fps "
         f"({dt / iters * 1000:.3f} ms / batch of {batch}); {len(set(checks))} distinct "
         f"result sums over {n_unique} unique batches")
    if n_unique < iters:
        _log(f"WARNING: only {n_unique} unique batches for {iters} timed dispatches "
             "(BENCH_UNIQUE lowered?); number NOT defensible")
    if len(set(checks)) < min(n_unique, iters):
        _log("WARNING: fewer distinct results than unique inputs; number NOT defensible")

    flops = flops_per_frame(pipe, host_batches[0][0])
    implied = fps * flops
    _log(f"FLOP count (unfused route): {flops / 1e9:.3f} GFLOP/frame ⇒ "
         f"{implied / 1e12:.2f} TFLOP/s ({100 * implied / H100_BF16_PEAK_FLOPS:.2f}% of "
         f"the H100's 989 TFLOP/s dense bf16)")
    if implied > H100_BF16_PEAK_FLOPS:
        _log("WARNING: figure exceeds hardware peak; NOT defensible")

    if measure_compute:
        k = int(os.environ.get("BENCH_SCAN_ITERS", "10"))
        base = xs[0]
        gen = torch.Generator(device=dev).manual_seed(0)

        def compute_program():
            total = torch.zeros((), device=dev)
            for _ in range(k):
                noise = torch.randint(-25, 26, base.shape, generator=gen, device=dev)
                x = (base.int() + noise).clamp(0, 255).to(torch.uint8)
                _, valid, refined = pipe.forward_device(x)
                total = total + refined.sum() + valid.sum()
            return float(total)

        compute_program()
        n_disp = 4
        t0 = time.perf_counter()
        vals = [compute_program() for _ in range(n_disp)]
        dt_c = time.perf_counter() - t0
        fps_c = batch * k * n_disp / dt_c
        _log(f"compute-only ({k} batches per fetch): {fps_c:.1f} fps "
             f"({dt_c / (k * n_disp) * 1000:.3f} ms / batch); {len(set(vals))}/{n_disp} "
             "distinct results")
        _log(f"share of the bf16 peak (compute-only): "
             f"{100 * fps_c * flops / H100_BF16_PEAK_FLOPS:.2f}%")
        _log(f"pipelined/compute agreement: {fps / fps_c:.2f}x")

    print(json.dumps({"metric": "fps_full_pipeline_320x240", "value": round(fps, 1),
                      "unit": "fps", "vs_baseline": round(fps / 200.0, 2)}))


if __name__ == "__main__":
    main()
