"""Benchmark CLI (``deepcharuco_tpu.cli.benchmark``): the served pipeline's
throughput at a chosen batch, input format and path.

Protocol (the root ``bench.py``'s): every timed batch is its own, made
before the timing and already resident on the device (``--iters`` distinct
batches); the loop keeps ``--depth`` batches in flight and copies every
result to the host. The copies go into pinned memory on the compute
stream, right behind the batch that makes them, and the host waits on each
batch's event (``serving._Lane``): a plain ``.cpu()`` of the oldest result
would queue behind the newer batch and make depth 2 serial, and the pose
graph's outputs are overwritten by the next replay. ``--fetch refined``
copies the refined corners only.

Paths: two-stage (default), ``--with-pose``, ``--hires``, the geometry
decode (``--geom-*``), ``--breakdown`` (detector alone and two-stage),
``--fused-head`` (the detector's cuDNN heads + the decode kernel against
the fused head + decode kernel on the same batches, with their agreement),
``--multi-stream`` (``serving.StreamServer``, or ``DeviceQueueServer`` with
``--stream-chunk``). :func:`run` returns the figures as a dict; ``main``
prints them. ``--image`` needs cv2. Runs on the card unless ``--device
cpu``: ``python -m deepcharuco_tpu_torch.cli.benchmark [--device cpu]``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import time


def build_argparser():
    p = argparse.ArgumentParser(description="DeepCharuco benchmark on the card")
    p.add_argument("--config", default=None)
    p.add_argument("--deepc", default=None)
    p.add_argument("--refinenet", default=None)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--input", choices=["gray", "bgr"], default="gray")
    p.add_argument("--with-pose", action="store_true",
                   help="include the batched PnP solve")
    p.add_argument("--image", default=None,
                   help="benchmark frame (needs cv2; else the board render)")
    p.add_argument("--breakdown", action="store_true",
                   help="also time the detector alone and two-stage")
    p.add_argument("--multi-stream", type=int, default=0,
                   help="serve N independent video streams through serving.StreamServer "
                        "and report aggregate fps and per-step latency")
    p.add_argument("--size", default=None, help="override input resolution WxH (e.g. 640x480)")
    p.add_argument("--frames-per-stream", type=int, default=64)
    p.add_argument("--stream-chunk", type=int, default=0,
                   help="with --multi-stream: serve via DeviceQueueServer, N steps of "
                        "every stream per launch (adds N frame intervals of latency); "
                        "0 = per-step StreamServer")
    p.add_argument("--hires", nargs="?", type=int, const=2, default=0, choices=[2, 4],
                   metavar="SCALE",
                   help="hi-res patch tap: frames at SCALE× the config resolution (bare "
                        "flag = 2), detector on the pooled view, RefineNet on full-res "
                        "patches")
    p.add_argument("--depth", type=int, default=2,
                   help="batches in flight while results are fetched (1 = serial)")
    p.add_argument("--fetch", choices=["all", "refined"], default="all",
                   help="per batch: copy every output to the host, or the refined "
                        "corners only")
    p.add_argument("--rn-patch-size", type=int, choices=[24, 32], default=24,
                   help="RefineNet patch size (match the checkpoint)")
    p.add_argument("--geom-decode", action="store_true",
                   help="time the geometry-consistent decode (ops/geom.py)")
    p.add_argument("--geom-ransac", type=int, default=32,
                   help="with --geom-decode: RANSAC seed subsets (0 = least squares)")
    p.add_argument("--geom-fill", action="store_true",
                   help="with --geom-decode: also fill undetected in-frame ids")
    p.add_argument("--rn-decode", choices=["soft", "offset", "avg"], default=None,
                   help="RefineNet heatmap decode (offset/avg need an offset-head "
                        "checkpoint). Default: hard argmax")
    p.add_argument("--fused-head", action="store_true",
                   help="A/B the detector→keypoints stage: cuDNN heads + the decode "
                        "kernel against the fused head + decode kernel; checks agreement")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the plain versions)")
    return p


def _frame(cfg, args, fmt: str = "bgr"):
    """One uint8 frame, BGR (H, W, 3) or, ``fmt="gray"``, (H, W):
    ``--image`` resized to the config's input, else the board render pasted
    on gray 90, centered left to right, at the top (its three channels are
    equal, so its gray view is any one of them, as cv2's conversion gives)."""
    import numpy as np

    if args.image:
        from deepcharuco_tpu_torch.cli import need_cv2

        cv2 = need_cv2("--image")
        img = cv2.imread(args.image)
        if img is None:
            raise SystemExit(f"cannot read --image {args.image}")
        img = cv2.resize(img, cfg.input_size)
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if fmt == "gray" else img
    from deepcharuco_tpu_torch.board import rendered_board

    mins = min(cfg.input_size)
    gray, _ = rendered_board(cfg, mins)
    h, w = cfg.input_hw
    frame = np.full((h, w), 90, np.uint8)
    x0 = (w - mins) // 2
    frame[:mins, x0:x0 + mins] = gray
    return frame if fmt == "gray" else np.repeat(frame[..., None], 3, axis=-1)


def _input_variants(frames, n, dev):
    """``n`` device-resident copies of a host batch, each under its own
    seeded ±15-level noise, so that no timed batch repeats."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        noise = rng.integers(-15, 16, frames.shape, dtype=np.int16)
        v = np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        out.append(torch.from_numpy(v).to(dev))
    return out


def time_fn(fn, inputs, iters, warmup, depth=2, fetch="all", device=None):
    """Seconds for ``iters`` calls of ``fn`` (a device tensor in, a tuple of
    device tensors out) over ``inputs`` in turn, ``depth`` calls in flight,
    every result copied to the host (``fetch="refined"``: element 2 only).
    Returns (seconds, the host copies of the last result)."""
    import torch

    from deepcharuco_tpu_torch.serving import _Lane

    lane = _Lane(device if device is not None else inputs[0].device, depth)
    pick = (lambda out: out) if fetch == "all" else (lambda out: (out[2],))
    n = len(inputs)
    last = None
    for i in range(warmup):
        last = lane.fetch(lane.download(pick(fn(inputs[i % n]))))
    q = collections.deque()
    if lane.cuda:
        torch.cuda.synchronize(lane.device)
    t0 = time.perf_counter()
    for i in range(iters):
        q.append(lane.download(pick(fn(inputs[i % n]))))
        if len(q) > depth:
            last = lane.fetch(q.popleft())
    while q:
        last = lane.fetch(q.popleft())
    return time.perf_counter() - t0, last


def _refinenet_variables(args):
    """The RefineNet's weights: ``--refinenet`` in any weight form, else
    seeded random weights of the variant the flags ask for."""
    import torch

    from deepcharuco_tpu_torch.models import RefineNet
    from deepcharuco_tpu_torch.pipeline import load_model_variables
    from deepcharuco_tpu_torch.weights import refinenet_variables

    if args.refinenet is not None:
        return load_model_variables(args.refinenet, "refinenet")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        rn = RefineNet(torch.float32, patch_size=args.rn_patch_size,
                       offset_head=args.rn_decode in ("offset", "avg"))
        return refinenet_variables(rn.state_dict())


def _serve_streams(args, pipe, frame, dev):
    """``--multi-stream``: every frame made before the timing, unique per
    stream and step; a throwaway server of the same shape warms up first."""
    import numpy as np

    from deepcharuco_tpu_torch.serving import DeviceQueueServer, StreamServer, VideoStream

    rng = np.random.default_rng(0)

    def stream_frames(sid):
        out = []
        for _ in range(args.frames_per_stream):
            noise = rng.integers(-25, 26, frame.shape, np.int16)
            out.append(np.clip(frame.astype(np.int16) + noise + sid, 0, 255).astype(np.uint8))
        return out

    def make_server(streams):
        if args.stream_chunk > 0:
            return DeviceQueueServer(pipe, streams, chunk=args.stream_chunk,
                                     with_pose=args.with_pose)
        return StreamServer(pipe, streams, with_pose=args.with_pose)

    streams = [VideoStream(iter(stream_frames(s)), name=f"s{s}")
               for s in range(args.multi_stream)]
    server = make_server(streams)
    warm = [VideoStream(iter([frame] * max(1, args.stream_chunk)), name="warm")
            for _ in range(args.multi_stream)]
    for _ in make_server(warm).run():
        pass
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    n_frames, lat = 0, []
    t0 = t_prev = time.perf_counter()
    for results in server.run():
        now = time.perf_counter()
        lat.append(now - t_prev)
        t_prev = now
        n_frames += len(results)
    dt = time.perf_counter() - t0
    h, w = frame.shape[:2]
    fps = n_frames / dt
    if args.stream_chunk > 0:
        latency = 1000 * float(np.percentile(lat, 95))
        lat_txt = (f"chunk-boundary latency {latency:.1f} ms "
                   f"(+{args.stream_chunk} frame-intervals queueing)")
        mode = f" (device-queue chunk={args.stream_chunk})"
    else:
        latency = 1000 * float(np.median(lat))
        lat_txt = f"median step latency {latency:.1f} ms"
        mode = ""
    text = (f"multi-stream: {args.multi_stream} streams @ {w}x{h}"
            f"{' (hires tap)' if args.hires else ''}{mode}: {fps:.1f} fps aggregate "
            f"({fps / args.multi_stream:.1f} fps/stream), {lat_txt}")
    return {"label": "multi-stream", "fps": fps, "fps_per_stream": fps / args.multi_stream,
            "latency_ms": latency, "frames": n_frames, "seconds": dt, "lines": [text]}


def run(args) -> dict:
    """The benchmark of the parsed ``args``: a dict of its figures (``fps``,
    ``ms_per_batch`` and, per option, the breakdown's, the A/B's and the
    servers') and ``lines``, the report ``main`` prints."""
    import numpy as np
    import torch

    from deepcharuco_tpu_torch.configs import (default_config, load_configuration,
                                               scaled_config)
    from deepcharuco_tpu_torch.pipeline import (Camera, InferencePipeline, _to_gray_input,
                                                is_quantized_npz, load_model_variables,
                                                two_stage_forward)
    from deepcharuco_tpu_torch.models.quant import qvars_from_npz
    from deepcharuco_tpu_torch.serving import check_hbm_budget
    from deepcharuco_tpu_torch._device import resolve_device

    dev = resolve_device(args.device)
    cfg = load_configuration(args.config) if args.config else default_config()
    if args.size:
        w, h = (int(v) for v in args.size.lower().split("x"))
        cfg = dataclasses.replace(cfg, input_size=(w, h))
    if args.hires and (args.breakdown or args.fused_head):
        raise SystemExit("--hires composes with --with-pose only "
                         "(breakdown/fused-head time the base-res stages)")
    det_quant = "int8" if is_quantized_npz(args.deepc) else None
    if det_quant and args.fused_head:
        raise SystemExit("--fused-head needs the float detector (its trunk); pass a "
                         "float checkpoint")
    frame_cfg = scaled_config(cfg, args.hires) if args.hires else cfg
    frame = _frame(frame_cfg, args, args.input)

    eff_batch = (max(1, args.stream_chunk) * args.multi_stream if args.multi_stream > 0
                 else args.batch)
    gh, gw = frame.shape[0] // max(1, args.hires), frame.shape[1] // max(1, args.hires)
    if dev.type == "cuda":
        try:
            check_hbm_budget(eff_batch, gh, gw, context="benchmark batch", device=dev)
        except ValueError as e:
            raise SystemExit(str(e))

    dv = (qvars_from_npz(args.deepc) if det_quant
          else load_model_variables(args.deepc, "detector", cfg.n_ids))
    rv = _refinenet_variables(args)
    camera = None
    if args.with_pose:
        fh, fw = frame.shape[:2]
        camera = Camera(K=np.array([[fw, 0, fw / 2], [0, fw, fh / 2], [0, 0, 1]], np.float32),
                        dist=np.zeros(5, np.float32))
    pipe = InferencePipeline(cfg, dv, rv, camera=camera, det_quant=det_quant,
                             rn_patch_size=args.rn_patch_size, rn_decode=args.rn_decode,
                             hires=args.hires, geom_decode=args.geom_decode,
                             geom_fill=args.geom_fill, geom_ransac=args.geom_ransac,
                             device=dev)
    if args.multi_stream > 0:
        return _serve_streams(args, pipe, frame, dev)

    frames = np.broadcast_to(frame, (args.batch, *frame.shape)).copy()
    xs = _input_variants(frames, args.iters, dev)
    timing = dict(iters=args.iters, warmup=args.warmup, depth=args.depth, device=dev)
    fn = lambda x: pipe.forward_device(x, with_pose=args.with_pose)
    dt, last = time_fn(fn, xs, fetch=args.fetch, **timing)
    fps = args.batch * args.iters / dt
    label = "full+pose" if args.with_pose else "two-stage"
    if args.hires:
        label += " (hires tap)"
    if args.geom_decode:
        label += " (geom decode)"
    res = {"label": label, "fps": fps, "ms_per_batch": 1e3 * dt / args.iters,
           "batch": args.batch, "iters": args.iters,
           "valid_per_frame": (float(np.asarray(last[1]).sum()) / args.batch
                               if args.fetch == "all" else None),
           "lines": [f"{label}: {fps:.1f} fps  ({dt / args.iters * 1000:.2f} ms / batch of "
                     f"{args.batch})"]}

    if args.breakdown:
        det = pipe.detector

        def det_prog(x):
            # the logits, and a small leaf at index 2 for --fetch refined
            with torch.inference_mode():
                out = det(_to_gray_input(x))
            return out["loc"], out["ids"], out["loc"][:, 0, 0, :2]

        dt_d, _ = time_fn(det_prog, xs, fetch=args.fetch, **timing)
        two = lambda x: two_stage_forward(det, pipe.refinenet, x, cfg.n_ids, device=dev)
        dt_2, _ = time_fn(two, xs, fetch=args.fetch, **timing)
        res["detector_only_fps"] = args.batch * args.iters / dt_d
        res["two_stage_fps"] = args.batch * args.iters / dt_2
        res["lines"] += [f"detector-only: {res['detector_only_fps']:.1f} fps",
                         f"two-stage: {res['two_stage_fps']:.1f} fps"]

    if args.fused_head:
        from deepcharuco_tpu_torch.ops import pred_to_keypoints
        from deepcharuco_tpu_torch.ops.cuda_fused import fused_head_decode, head_params

        det = pipe.detector
        folded = head_params(dv, cfg.n_ids, dev)

        @torch.inference_mode()
        def unfused(x):
            out = det(_to_gray_input(x))
            return pred_to_keypoints(out["loc"], out["ids"], cfg.n_ids)

        @torch.inference_mode()
        def fused(x):
            trunk = det(_to_gray_input(x), trunk_only=True)["trunk"]
            return fused_head_decode(trunk, folded, cfg.n_ids)

        kx, vx = (t.cpu().numpy() for t in unfused(xs[0]))
        kf, vf = (t.cpu().numpy() for t in fused(xs[0]))
        both = vx & vf
        agree_valid = float((vx == vf).mean())
        agree_kpts = (float((np.abs(kx - kf).max(-1)[both] < 1e-6).mean())
                      if both.any() else 1.0)
        dt_x, _ = time_fn(unfused, xs, **timing)
        dt_f, _ = time_fn(fused, xs, **timing)
        res.update(unfused_fps=args.batch * args.iters / dt_x,
                   unfused_ms_per_batch=1e3 * dt_x / args.iters,
                   fused_fps=args.batch * args.iters / dt_f,
                   fused_ms_per_batch=1e3 * dt_f / args.iters,
                   agree_valid=agree_valid, agree_kpts=agree_kpts)
        res["lines"] += [
            f"detector→keypoints unfused: {res['unfused_fps']:.1f} fps "
            f"({res['unfused_ms_per_batch']:.2f} ms/batch)",
            f"detector→keypoints fused:   {res['fused_fps']:.1f} fps "
            f"({res['fused_ms_per_batch']:.2f} ms/batch)",
            f"agreement: valid {agree_valid:.4f}, coords(valid∩) {agree_kpts:.4f}"]
    return res


def main(argv=None):
    res = run(build_argparser().parse_args(argv))
    for line in res["lines"]:
        print(line)
    return res


if __name__ == "__main__":
    main()
