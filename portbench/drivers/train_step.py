"""Detector training: the port's ``train.make_detector_train_step()`` on
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

from portbench import faults, frames, program
from portbench.common import full_float32
from portbench.drivers import RunBase
from portbench.reference import train as ref_train


class Run(RunBase):
    def setup(self):
        t = self.cfg["train"]
        torch.backends.cudnn.allow_tf32 = t["conv_tf32"]
        torch.backends.cuda.matmul.allow_tf32 = t["matmul_tf32"]
        p = self.p
        self.start = program.initial_detector(self.cfg, self.seed, self.device)
        host = frames.training_batches(self.seed, self.cfg["input_hw"], self.cfg["n_ids"],
                                       p["batch"], p["pool_batches"], p)
        self.pool_dev = [tuple(torch.from_numpy(a).to(self.device) for a in b) for b in host]
        self.state, self.step = program.train_state(self.cfg, self.start, self.device)
        faults.plant(self)
        names = dict(self.state.model.named_parameters())
        self.record = {"start": {k: self.start[k] for k in names}, "losses": []}
        b1 = t["betas"][0]
        for i in range(p["checked_steps"]):
            self.state, aux = self.step(self.state, *self.pool_dev[i])
            self.record["losses"].append(float(aux["loss"]))
            if i == 0:
                opt = self.state.optimizer.state
                self.record["grad"] = {
                    k: (opt[v]["exp_avg"] / (1 - b1) if v in opt else torch.zeros_like(v))
                    .detach().clone() for k, v in names.items()}
        self.record["end"] = {k: v.detach().clone() for k, v in names.items()}
        self.checked = [self.pool_dev[i] for i in range(p["checked_steps"])]
        for i in range(p["warm_steps"]):
            self.state, _ = self.step(self.state, *self.pool_dev[(p["checked_steps"] + i)
                                                                 % len(self.pool_dev)])
        self.sync()

    def window(self):
        p = self.p
        n = 0
        self.launched_at = []
        self.begin()
        while time.perf_counter() - self.t_start < self.seconds:
            with self.spans.span("train.step") if self.trace else nullcontext():
                self.state, _ = self.step(self.state, *self.pool_dev[n % len(self.pool_dev)])
            n += 1
            self.launched_at.append(time.perf_counter())
            self.tick()
        self.sync()
        self.end()
        self.steps = n
        self.attempted = n * p["batch"]
        self.e2e["train_samples_per_s"] = self.attempted / self.window_s

    def reference(self, q=None):
        t = self.cfg["train"]
        kw = {} if q is None else {"q": q}
        with full_float32():
            losses, grad, end = ref_train.steps(self.record["start"], self.checked, t["lr"],
                                                t["betas"], t["eps"], **kw)
        return {"losses": losses, "grad": grad, "end": end}

    def judge(self):
        return ref_train.judge(self.record, self.reference())
