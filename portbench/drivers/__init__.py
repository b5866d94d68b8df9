"""Traffic generators, one per kind of mix (``offline``, ``stream``,
``train_step``, ``train_devsynth``). A mix file names its driver and gives
its parameters; a driver's ``Run`` does the set-up, the window and the
comparison of one run, calling the cell's program module (``run.prog``,
``programs/__init__.py``) for all that belongs to the model. A driver
module also declares ``TASK`` ("serve" or "train": which of the program
module's functions it calls), ``SMALL`` (the parameters of its CPU tests'
runs) and ``control_inputs(c, seed, device)`` (the inputs a run of
``seed`` judges, for the program module's ``control``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from portbench.tracing import Spans, Stretch


class RunBase:
    """What every driver's run holds and reports."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device: torch.device, fault: Optional[str]):
        self.cell = cell
        self.cfg = cell["config"]
        self.prog = cell["program"]
        self.p = cell["params"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.fault = fault
        self.spans = Spans(device)
        self.stretch: Optional[Stretch] = (Stretch(device, self.spans, self.p["trace_skip"],
                                                   self.p["trace_steps"], self.p["trace_drop"])
                                           if trace else None)
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.t_start = self.t_end = 0.0

    def begin(self) -> None:
        """The window opens: the profiler (traced runs) starts waiting."""
        if self.stretch is not None:
            self.stretch.start()
        self.t_start = time.perf_counter()

    def end(self) -> None:
        """The window has closed (its work finished)."""
        self.t_end = time.perf_counter()
        self.window_s = self.t_end - self.t_start
        if self.stretch is not None:
            self.stretch.stop()

    def tick(self) -> None:
        """One batch or step of the window done."""
        if self.stretch is not None:
            self.stretch.step()

    def rate_before_trace(self, times, per: float) -> Optional[float]:
        """Items per second over the window before the profiler started
        (all of it in an untraced run): ``per`` items at each host time in
        ``times``."""
        t_on = self.stretch.t_on if self.stretch is not None else float("inf")
        end = min(t_on, self.t_end)
        n = sum(1 for t in times if t < end)
        return n * per / (end - self.t_start) if n and end > self.t_start else None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        for name in ("pipe", "state", "step", "pool_dev", "dispatch", "synth"):
            if hasattr(self, name):
                setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
