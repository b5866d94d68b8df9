"""Spans and the profiled stretch of a traced run.

:class:`Spans` records named spans from the benchmark's own files: the
host clock at both ends and, on the card, a CUDA event on the current
stream at both ends; each span is also a ``torch.profiler.record_function``
range, which the profiler shows on the host and on the device. Forward
hooks open and close spans around a module's calls; :meth:`Spans.wrap`
puts one around a bound method.

:class:`Stretch` profiles a short steady stretch of the window with
``torch.profiler`` (CPU and CUDA activity) on a schedule: the driver calls
:meth:`Stretch.step` after every batch or step, the profiler waits
``skip - 1`` of them, warms up over one and records ``active``; the
events are read when the recording ends, with no synchronisation in the
window. Device readings leave out the first ``drop`` recorded steps: the
tracing's start stalls the host, and with batches in flight the device
runs dry a step or two later. The profiler slows the host from its
warm-up on (``t_on``), so host-clock readers take the window before it.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIXES = ("portbench.", "detector", "refinenet", "forward_device", "solve_pose",
                 "train.step")


class Spans:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.done: List[list] = []         # [name, t0, t1, ev0, ev1]
        self._open: Dict[str, list] = {}

    def open(self, name: str) -> None:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        self._open.setdefault(name, []).append((rf, time.perf_counter(), ev))

    def close(self, name: str) -> None:
        rf, t0, ev0 = self._open[name].pop()
        t1 = time.perf_counter()
        ev1 = None
        if self.cuda:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        rf.__exit__(None, None, None)
        self.done.append([name, t0, t1, ev0, ev1])

    @contextlib.contextmanager
    def span(self, name: str):
        self.open(name)
        try:
            yield
        finally:
            self.close(name)

    def hook(self, module: torch.nn.Module, name: str) -> None:
        module.register_forward_pre_hook(lambda m, a: self.open(name))
        module.register_forward_hook(lambda m, a, o: self.close(name))

    def wrap(self, obj, method: str, name: str) -> None:
        fn = getattr(obj, method)

        def wrapped(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(obj, method, wrapped)

    def host_ms(self, name: str, before: float = float("inf")) -> List[float]:
        """Host milliseconds of every span ``name`` that ended before the
        host time ``before``."""
        return [(t1 - t0) * 1e3 for n, t0, t1, _, _ in self.done if n == name and t1 < before]

    def event_ms(self, name: str, before: float = float("inf")) -> List[float]:
        """Stream milliseconds between the two events of every span ``name``
        that ended before the host time ``before``."""
        if not self.cuda:
            return []
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for n, _, t1, e0, e1 in self.done
                if n == name and t1 < before]


class Stretch:
    """A scheduled profile of ``active`` steps after ``skip`` steps, read
    from the step after the first ``drop`` recorded ones."""

    def __init__(self, device: torch.device, spans: Spans, skip: int, active: int,
                 drop: int):
        self.device = device
        self.spans = spans
        self.skip, self.active, self.drop = max(1, skip), active, drop
        self.prof = None
        self.t_on = float("inf")
        self.ops: List[Tuple[str, float, float]] = []            # device operations, µs
        self.ranges: Dict[str, List[Tuple[float, float]]] = {}   # spans on the device, µs
        self.host: List[Tuple[float, float, str]] = []           # host events, µs

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Run the profiler once in set-up: its first start initialises the
        device tracing, which takes seconds."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.ones(8, device=self.device).sum().item()

    def start(self) -> None:
        from torch.profiler import profile, schedule

        sched = schedule(wait=self.skip - 1, warmup=1, active=self.active, repeat=1)
        self.prof = profile(activities=self._activities(), schedule=sched,
                            on_trace_ready=self._collect)
        self.prof.__enter__()

    def step(self) -> None:
        """After every batch or step of the window."""
        if self.prof is None:
            return
        from torch.profiler import ProfilerAction

        if self.t_on == float("inf") and self.prof.current_action == ProfilerAction.NONE:
            t = time.perf_counter()
            self.prof.step()
            if self.prof.current_action != ProfilerAction.NONE:
                self.t_on = t
        else:
            self.prof.step()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None

    def _collect(self, prof) -> None:
        from torch.autograd import DeviceType

        names = {d[0] for d in self.spans.done} | set(self.spans._open)
        events = prof.events()
        steps = sorted(e.time_range.start for e in events
                       if e.device_type != DeviceType.CUDA and e.name.startswith("ProfilerStep"))
        cut = steps[self.drop] if len(steps) > self.drop else float("-inf")
        for e in events:
            tr = e.time_range
            if e.device_type != DeviceType.CUDA:
                self.host.append((tr.start, tr.end, e.name))
            elif tr.start < cut:
                continue
            elif getattr(e, "is_user_annotation", False) or e.name in names:
                self.ranges.setdefault(e.name, []).append((tr.start, tr.end))
            else:
                self.ops.append((e.name, tr.start, tr.end))
        self.ops.sort(key=lambda o: o[1])

    # ----- readings --------------------------------------------------------
    def busy(self) -> Optional[Tuple[float, float]]:
        """(seconds some device operation ran, seconds from the first
        operation's start to the last one's end); None without operations."""
        if not self.ops:
            return None
        busy, lo, hi = 0.0, self.ops[0][1], self.ops[0][2]
        for _, a, b in self.ops[1:]:
            if a > hi:
                busy += hi - lo
                lo, hi = a, b
            else:
                hi = max(hi, b)
        busy += hi - lo
        return busy / 1e6, (max(b for _, _, b in self.ops) - self.ops[0][1]) / 1e6

    def device_ms_of(self, name: str) -> Optional[Tuple[float, int]]:
        """(summed ms of the kernels that start inside the device-side
        intervals of span ``name``, number of those intervals); None where
        the trace has none. A span's kernels run in order on one stream, so
        its interval holds them and no other span's; copies and memsets
        (the copy stream's uploads among them) are left out."""
        rs = self.ranges.get(name)
        if not rs:
            return None
        starts = [a for _, a, _ in self.ops]
        total = 0.0
        for lo, hi in rs:
            for n, a, b in self.ops[bisect.bisect_left(starts, lo):
                                    bisect.bisect_right(starts, hi)]:
                if not n.startswith(("Memcpy", "Memset")):
                    total += b - a
        return (total / 1e3, len(rs)) if total > 0 else None

    def kernel_ms(self, part: str, unless: str = "\0") -> Optional[Tuple[float, int]]:
        """(summed ms, count) of device operations whose name holds ``part``
        and not ``unless``."""
        ks = [(b - a) for n, a, b in self.ops if part in n and unless not in n]
        return (sum(ks) / 1e3, len(ks)) if ks else None

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        hi = self.ops[0][2] if self.ops else 0.0
        for _, a, b in self.ops[1:]:
            if a > hi:
                gaps.append((a - hi, hi))
            hi = max(hi, b)
        gaps.sort(reverse=True)
        named = [[self._host_at(t), g / 1e6] for g, t in gaps[:top]]
        return {"device_ops": [[n[:160], s / 1e6] for n, s in ops], "idle_gaps": named}

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span and the innermost other host event
        at time ``t``."""
        inner_span, inner_op = None, None
        for a, b, name in self.host:
            if a <= t <= b:
                if name.startswith(SPAN_PREFIXES):
                    if inner_span is None or a >= inner_span[0]:
                        inner_span = (a, name)
                elif inner_op is None or a >= inner_op[0]:
                    inner_op = (a, name)
        parts = [x[1] for x in (inner_span, inner_op) if x is not None]
        return " / ".join(parts) if parts else "(no host event)"
