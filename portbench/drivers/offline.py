"""Offline batches: a pool of unique uint8 frames made from the seed on the
host, cycled, through ``serving.pipelined_map`` with ``depth`` batches in
flight (pinned staging, upload on a copy stream, results into pinned
memory). The window runs from the first batch's submission to the last
result on the host; batches are submitted until ``--seconds`` have passed
and the ones in flight then are finished and counted.

``fps``: frames whose corners and pose reached the host, over the window.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import frames
from portbench.common import full_float32, sample_rows
from portbench.drivers import RunBase
from portbench.harness import ROOT

TASK = "serve"
SMALL = dict(batch=2, pool_batches=2, warm_batches=1, check_frames=4,
             trace_skip=1, trace_steps=1, trace_drop=0)


def control_inputs(c: dict, seed: int, device) -> dict:
    """The frames a run of ``seed`` judges (its first batches' sample) and
    the cell's batch size."""
    cfg, p = c["config"], c["params"]
    pool = frames.batch_pool(seed, cfg["input_hw"], p["batch"], p["pool_batches"], p)
    n_batches = max(1, -(-p["check_frames"] // p["batch"]))
    picks = sample_rows(seed, n_batches, p["batch"], p["check_frames"])
    return {"frames": np.stack([pool[b % len(pool)][r] for b, r in picks]),
            "block": p["batch"]}


class Run(RunBase):
    def setup(self):
        from deepcharuco_tpu_torch.serving import pipelined_map

        self.pipelined_map = pipelined_map
        self.pipe = self.prog.build(self.cfg, ROOT, self.seed, self.device)
        self.prog.plant(self)
        p = self.p
        self.pool = frames.batch_pool(self.seed, self.cfg["input_hw"], p["batch"],
                                      p["pool_batches"], p)
        for _ in self.pipelined_map(self._fn, self.pool[:p["warm_batches"]], p["depth"],
                                    self.device):
            pass
        self.sync()
        if self.trace:
            self.prog.instrument(self.spans, self.pipe, layers=True)

    def _fn(self, x):
        return self.pipe.forward_device(x, with_pose=self.p["with_pose"])

    def window(self):
        p = self.p
        n_pool, batch = len(self.pool), p["batch"]
        self.sent, self.results, self.done_at = [], [], []
        self.begin()

        def feed():
            while time.perf_counter() - self.t_start < self.seconds:
                self.sent.append(len(self.sent) % n_pool)
                yield self.pool[self.sent[-1]]

        for out in self.pipelined_map(self._fn, feed(), p["depth"], self.device):
            # copies, so that the pinned buffers go back to the host allocator
            self.results.append(tuple(np.array(a) for a in out))
            self.done_at.append(time.perf_counter())
            self.tick()
        self.end()
        self.attempted = len(self.sent) * batch
        done = len(self.results) * batch
        self.failed = self.attempted - done
        self.e2e["fps"] = done / self.window_s

    def judge(self):
        p = self.p
        picks = sample_rows(self.seed, len(self.results), p["batch"], p["check_frames"])
        frames_u8 = np.stack([self.pool[self.sent[b]][r] for b, r in picks])
        out = {k: np.stack([self.results[b][i][r] for b, r in picks])
               for i, k in enumerate(self.prog.OUTPUTS)}
        with full_float32():
            return self.prog.judge(self.cfg, ROOT, self.seed, self.device, frames_u8, out)
