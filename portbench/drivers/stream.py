"""Live cameras: S streams at ``fps`` frames per second each, open loop.
The cameras run in lockstep: each yields frame k at its due time
``t0 + k/fps``, sleeping until then, never waits for results, and reads a
pool of unique frames made from the seed at its own offset, so no two
frames of one step are the same. ``serving.StreamServer(pipe, streams, with_pose=True)`` serves them,
one frame of every stream per step.

``latency_p95_ms``: the 95th percentile, over every frame due in the
window, of the time from its due time to its result on the host. A frame
that never comes back counts as failed.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext

import numpy as np

from portbench import frames
from portbench.common import full_float32, sample_rows
from portbench.drivers import RunBase
from portbench.harness import ROOT

TASK = "serve"
SMALL = dict(streams=2, pool_frames=8, warm_steps=1, tail_steps=1, fps=10.0,
             trace_skip=1, trace_steps=1, trace_drop=0, check_frames=4)


def control_inputs(c: dict, seed: int, device) -> dict:
    """The frames a run of ``seed`` judges (a sample of its first steps'
    frames) and the cell's step size, its number of cameras."""
    cfg, p = c["config"], c["params"]
    pool = frames.frame_pool(seed, cfg["input_hw"], p["pool_frames"], p)
    s = p["streams"]
    stride = len(pool) // s
    picks = sample_rows(seed, max(1, -(-p["check_frames"] // s)) * 4, s, p["check_frames"])
    return {"frames": np.stack([pool[(cc * stride + k) % len(pool)] for k, cc in picks]),
            "block": s}


class Run(RunBase):
    def setup(self):
        from deepcharuco_tpu_torch.serving import StreamServer, VideoStream

        self.Server, self.Stream = StreamServer, VideoStream
        self.pipe = self.prog.build(self.cfg, ROOT, self.seed, self.device)
        self.prog.plant(self)
        p = self.p
        self.S = p["streams"]
        self.pool = frames.frame_pool(self.seed, self.cfg["input_hw"], p["pool_frames"], p)
        if self.S > len(self.pool):
            raise ValueError("pool_frames must be at least the number of streams")
        self.stride = len(self.pool) // self.S
        warm = [self.Stream([self.frame(c, k) for k in range(p["warm_steps"])])
                for c in range(self.S)]
        for _ in self.Server(self.pipe, warm, with_pose=p["with_pose"]).run():
            pass
        self.sync()
        if self.trace:
            self.prog.instrument(self.spans, self.pipe, layers=False)

    def frame(self, c: int, k: int) -> np.ndarray:
        return self.pool[(c * self.stride + k) % len(self.pool)]

    def due(self, k: int) -> float:
        return self.t0 + k / self.p["fps"]

    def camera(self, c: int):
        last = c == self.S - 1
        for k in range(self.n_steps):
            wait = self.due(k) - time.perf_counter()
            if wait > 0:
                with self.spans.span("portbench.wait_due") if self.trace else nullcontext():
                    time.sleep(wait)
            if last:
                self.pulled.append(time.perf_counter())
            yield self.frame(c, k)

    def window(self):
        p = self.p
        self.n_window = math.ceil(self.seconds * p["fps"])
        self.n_steps = self.n_window + p["tail_steps"]
        self.pulled, self.handed, self.served = [], [], []
        # the answers the comparison reads are drawn before the window and
        # copied as they come, so that no step's pinned buffers are kept
        picks = sample_rows(self.seed, self.n_window, self.S, p["check_frames"])
        wanted = {}
        for k, c in picks:
            wanted.setdefault(k, []).append(c)
        self.kept = {}
        self.begin()
        self.t0 = self.t_start
        streams = [self.Stream(self.camera(c)) for c in range(self.S)]
        for res in self.Server(self.pipe, streams, with_pose=p["with_pose"]).run():
            self.handed.append(time.perf_counter())
            k = len(self.served)
            self.served.append(set(res))
            for c in wanted.get(k, ()):
                if c in res:
                    self.kept[k, c] = {key: np.array(v) for key, v in res[c].items()}
            self.tick()
        self.end()
        end = self.t0 + self.seconds
        lat = []
        for k in range(self.n_window):
            if self.due(k) >= end:
                continue
            for c in range(self.S):
                self.attempted += 1
                if k < len(self.served) and c in self.served[k]:
                    lat.append((self.handed[k] - self.due(k)) * 1e3)
                else:
                    self.failed += 1
        self.latency_ms = lat
        self.e2e["latency_p95_ms"] = float(np.percentile(lat, 95)) if lat else math.inf

    def judge(self):
        picks = sorted(self.kept)
        frames_u8 = np.stack([self.frame(c, k) for k, c in picks])
        out = {key: np.stack([self.kept[k, c][key] for k, c in picks])
               for key in self.prog.OUTPUTS}
        with full_float32():
            return self.prog.judge(self.cfg, ROOT, self.seed, self.device, frames_u8, out)
