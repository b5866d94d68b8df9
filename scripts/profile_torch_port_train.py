#!/usr/bin/env python3
"""Where the port's detector trainer spends its time on the card.

At the trainer's shape (batch 32, 240×320, float32, cuDNN's default TF32
convolutions), for the on-card synthesis of one batch, one train step on a
fixed batch, and the two in turn (``synth_scan_program``, as
``cli.train --device-synth`` runs them), once and five times in a row:

- ms on the host to enqueue the work, and ms until the card has finished
  it (the card idle at the start), the mean of 5;
- the device operations ``torch.profiler`` sees and their summed device
  time, the top ones by device time, and the runtime calls that can make
  the host wait for the card (any ``cuda*Synchronize``, ``cudaMemcpy*``);
- a yardstick for the written-out training BatchNorm: forward + backward
  of one full-resolution layer (32×64×240×320) as the port computes it
  beside ``F.batch_norm(training=True)``.

Run on a machine with the card: ``python3 scripts/profile_torch_port_train.py``.
It prints the card's name and power limit and, last, one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def host_and_wall(fn, repeats=5):
    import torch

    host = wall = 0.0
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host += (t1 - t0) * 1e3 / repeats
        wall += (time.perf_counter() - t0) * 1e3 / repeats
    return host, wall


def profiled(fn):
    """(device operations, summed device ms, top 8 by device ms, host-wait calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    waits = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("cuda") and (
                "Synchronize" in e.name or e.name.startswith("cudaMemcpy")):
            waits[e.name] = waits.get(e.name, 0) + 1
    by = {}
    for e in dev:
        k = e.name[:70]
        by[k] = by.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    return len(dev), sum(by.values()), top, waits


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_torch_port_train: no CUDA device", file=sys.stderr)
        return 1
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.data import DeviceSynthesizer
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.parallel import synth_scan_program
    from deepcharuco_tpu_torch.train import (create_detector_state, flax_init_,
                                             make_detector_train_step)

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = default_config()
    bs = cfg.bs_train
    synth = DeviceSynthesizer(cfg, device=dev)
    state = create_detector_state(flax_init_(Detector(cfg.n_ids, torch.float32)).to(dev))
    step = make_detector_train_step()
    gen = torch.Generator(device=dev).manual_seed(0)
    fixed = synth.batch(gen, bs)
    program = synth_scan_program(step, lambda g: synth.batch(g, bs))
    out = {"card": smi}
    for name, fn in (("synthesis", lambda: synth.batch(gen, bs)),
                     ("train_step", lambda: step(state, *fixed)),
                     ("synthesis+step", lambda: program(state, gen)),
                     ("5 x synthesis+step", lambda: [program(state, gen) for _ in range(5)])):
        fn()
        host, wall = host_and_wall(fn)
        n_ops, busy, top, waits = profiled(fn)
        out[name] = {"host_ms": host, "wall_ms": wall, "device_ops": n_ops,
                     "device_ms": busy, "top": top, "host_waits": waits}
        print(f"{name}, batch {bs}: host {host:.3f} ms to enqueue, {wall:.3f} ms to finish; "
              f"{n_ops} device operations, {busy:.3f} ms summed device time; host waits "
              f"{waits or 'none'}", flush=True)
        for k, ms in top:
            print(f"  {ms:8.3f} ms  {k}", flush=True)

    # the written-out training BatchNorm against cuDNN's, one full-resolution layer
    x = torch.randn(bs, 64, 240, 320, device=dev, requires_grad=True)
    w = torch.ones(64, device=dev, requires_grad=True)
    b = torch.zeros(64, device=dev, requires_grad=True)
    g = torch.randn_like(x)

    def port_bn():
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + 1e-5) * w
        y = F.relu((x - mean[:, None, None]) * mul[:, None, None] + b[:, None, None])
        y.backward(g)

    def cudnn_bn():
        y = F.relu(F.batch_norm(x, None, None, w, b, True, 0.1, 1e-5))
        y.backward(g)

    for name, fn in (("bn_written_out", port_bn), ("bn_cudnn", cudnn_bn),
                     ("bn_written_out", port_bn), ("bn_cudnn", cudnn_bn)):
        _, wall = host_and_wall(fn)
        out.setdefault(name, []).append(wall)
    print(f"training BatchNorm + ReLU, forward + backward, 32×64×240×320 float32: written out "
          f"{out['bn_written_out']} ms, F.batch_norm(training=True) {out['bn_cudnn']} ms",
          flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
