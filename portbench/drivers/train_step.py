"""The detector's training: the port's ``train.make_detector_train_step()`` on
its float32 state with Adam, back to back, on a pool of labelled batches
made from the seed and resident on the card. Set-up builds the one state
from initial parameters made from the seed, drives it through the first
``checked_steps`` steps with the window's own call and feed (recording the
losses, the first gradient from Adam's first moment, and the parameters
before and after) and a few more, and hands that same state to the window.

``train_samples_per_s``: samples of every step launched in the window,
over the time from the first launch to the state synchronised after the
last.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import torch

from portbench import frames
from portbench.common import full_float32
from portbench.drivers import RunBase

TASK = "train"
SMALL = dict(batch=2, pool_batches=3, warm_steps=1, trace_skip=1, trace_steps=1,
             trace_drop=0)


def host_batches(c: dict, seed: int):
    cfg, p = c["config"], c["params"]
    return frames.training_batches(seed, cfg["input_hw"], cfg["n_ids"], p["batch"],
                                   p["pool_batches"], p)


def control_inputs(c: dict, seed: int, device) -> dict:
    """The batches of the checked steps of a run of ``seed``."""
    host = host_batches(c, seed)
    return {"batches": [tuple(torch.from_numpy(a).to(device) for a in host[i])
                        for i in range(c["params"]["checked_steps"])]}


class Run(RunBase):
    def setup(self):
        t = self.cfg["train"]
        torch.backends.cudnn.allow_tf32 = t["conv_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = t["matmul_tf32"]
        p = self.p
        self.start = self.prog.initial_state(self.cfg, self.seed, self.device)
        self.prepare()
        self.state, self.step = self.prog.train_state(self.cfg, self.start, self.device)
        self.prog.plant(self)
        self.bind()
        names = dict(self.state.model.named_parameters())
        self.record = {"start": {k: self.start[k] for k in names}, "losses": []}
        b1 = t["betas"][0]
        for i in range(p["checked_steps"]):
            aux = self.advance(i)
            self.record["losses"].append(float(aux["loss"]))
            if i == 0:
                opt = self.state.optimizer.state
                self.record["grad"] = {
                    k: (opt[v]["exp_avg"] / (1 - b1) if v in opt else torch.zeros_like(v))
                    .detach().clone() for k, v in names.items()}
        self.record["end"] = {k: v.detach().clone() for k, v in names.items()}
        self.checked = self.checked_batches()
        for i in range(p["warm_steps"]):
            self.advance(p["checked_steps"] + i)
        self.sync()

    def prepare(self):
        """The feed: the pool of batches, on the card."""
        host = host_batches(self.cell, self.seed)
        self.pool_dev = [tuple(torch.from_numpy(a).to(self.device) for a in b) for b in host]

    def bind(self):
        """After the faults are planted: nothing to bind for a pool."""

    def advance(self, i: int) -> dict:
        """Step ``i`` of the run (the pool's batch ``i``, cycled)."""
        self.state, aux = self.step(self.state, *self.pool_dev[i % len(self.pool_dev)])
        return aux

    def checked_batches(self) -> list:
        return [self.pool_dev[i] for i in range(self.p["checked_steps"])]

    def window(self):
        p = self.p
        n = 0
        self.launched_at = []
        self.begin()
        while time.perf_counter() - self.t_start < self.seconds:
            with self.spans.span("train.step") if self.trace else nullcontext():
                self.advance(n)
            n += 1
            self.launched_at.append(time.perf_counter())
            self.tick()
        self.sync()
        self.end()
        self.steps = n
        self.attempted = n * p["batch"]
        self.e2e["train_samples_per_s"] = self.attempted / self.window_s

    def reference(self, q=None):
        with full_float32():
            return self.prog.train_reference(self.cfg, self.record["start"], self.checked, q)

    def judge(self):
        return self.prog.judge_train(self.record, self.reference())
