"""Tracing and timing utilities (``deepcharuco_tpu.profiling``).

- :data:`RECORDER` and its module-level functions :func:`span`,
  :func:`open_span`, :func:`count`, :func:`spans`, :func:`counters`,
  :func:`reset`, :func:`anchor`, :func:`anchors`, :func:`host_ns` — the
  port's own spans and counters, always on (:class:`Recorder`);
- :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace of host and device activity;
- :class:`StageTimer` — wall-clock time per stage, the device synchronized
  around each stage so that asynchronous launches do not hide the cost;
- :func:`device_memory_stats` — device memory in use and its limit;
- :func:`force_fetch` — wait for results by copying one leaf of each to the
  host.

Every function that takes ``device`` reads None as the card, and without a
card that raises unless the caller passes ``device="cpu"``.

**The recorder**, one a process (:data:`RECORDER`), so that the spans of
every layer share one ring and one clock. A span has a name, a step id
that it shares with its children (a child given none takes its parent's),
its parent (by default the innermost span open on the same thread) and its
start and end on ``time.perf_counter_ns()``, the clock of every host
reading. Closed spans go into a ring of :data:`RING_SPANS`; counters are
integers that only add up. A span costs the host a few microseconds and
nothing else: it enters a ``torch.profiler.record_function`` range only
while a profiler records, so that the program's names sit beside the
device's operations on the profiler's own clock. ``device=True`` also
records a timing event on the current stream at each end; such events go
onto the host clock through anchors per card (:meth:`Recorder.anchor`),
an event and the host clock read together on an idle card, the first taken
when the first pipeline or server is built there. No span synchronises or
copies anything.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from deepcharuco_tpu_torch._device import resolve_device

# Closed spans the recorder keeps, the oldest dropped first: at about ten
# spans a step, several times the steps of a 40-second run of the
# live-camera server (30 steps a second) with its set-up.
RING_SPANS = 1 << 16

# Whether a profiler records: a fraction of a microsecond, where entering a
# record_function costs about 15 µs even with no profiler running.
_profiling = torch._C._autograd._profiler_enabled


class Span:
    """One span: ``name``, ``step``, ``parent`` (the parent :class:`Span` or
    None), ``t0``/``t1`` in ``perf_counter_ns`` (``t1`` None while open;
    they bracket the span's profiler range, when there is one) and
    ``ev0``/``ev1``, timing ``torch.Event``s on the stream current at either
    end (None without ``device=True``; a caller may set ``ev1`` to such an
    event it records itself). Used as a context manager it closes on exit."""

    __slots__ = ("name", "step", "parent", "t0", "t1", "ev0", "ev1", "_rec", "_stack",
                 "_rf")

    def __init__(self, rec: "Recorder", name: str, step, parent: Optional["Span"],
                 device: bool):
        self._rec = rec
        self._stack = None
        self.name = name
        self.step = parent.step if step is None and parent is not None else step
        self.parent = parent
        self.t1 = self.ev1 = self._rf = None
        self.t0 = time.perf_counter_ns()
        if _profiling():
            self._rf = torch.profiler.record_function(name)
            self._rf.__enter__()
        self.ev0 = _event() if device else None

    def child(self, name: str, device: bool = False) -> "Span":
        """A span under this one, with its step id, open on this thread."""
        return self._rec.span(name, None, device, parent=self)

    def close(self) -> None:
        if self.ev0 is not None:
            self.ev1 = _event()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.t1 = time.perf_counter_ns()
        stack = self._stack
        if stack is not None:
            if stack[-1] is self:
                stack.pop()
            else:
                stack.remove(self)
            self._stack = None
        self._rec._ring.append(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device_ms(self) -> float:
        """Milliseconds between the two events (both must have completed)."""
        return self.ev0.elapsed_time(self.ev1)


def _event() -> torch.Event:
    """A timing event recorded on the current stream of the current card:
    ``torch.Event`` finds the stream in C++, a few microseconds sooner than
    ``torch.cuda.Event``. The recorder's events are all of this one type,
    as ``elapsed_time`` takes no other."""
    ev = torch.Event("cuda", enable_timing=True)
    ev.record()
    return ev


class _Stacks(threading.local):
    """The open spans of each thread, innermost last."""

    def __init__(self):
        self.stack: List[Span] = []


class Recorder:
    """Spans and counters of one process (:data:`RECORDER` is the port's)."""

    def __init__(self, capacity: int = RING_SPANS):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = _Stacks()
        self._anchors: Dict[int, List[Tuple[torch.Event, int]]] = {}

    def open_span(self, name: str, step=None, device: bool = False,
                  parent: Optional[Span] = None) -> Span:
        """A span that stays open until its :meth:`Span.close`, in any order
        with other spans (a server's steps overlap), and is no parent by
        default: its children name it (:meth:`Span.child`)."""
        if parent is None:
            stack = self._local.stack
            parent = stack[-1] if stack else None
        return Span(self, name, step, parent, device)

    def span(self, name: str, step=None, device: bool = False,
             parent: Optional[Span] = None) -> Span:
        """A span for a ``with`` block: the parent of the spans opened on
        this thread until it closes."""
        s = self.open_span(name, step, device, parent)
        s._stack = self._local.stack
        s._stack.append(s)
        return s

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """The closed spans the ring holds (of ``name``), oldest first."""
        held = list(self._ring)
        return held if name is None else [s for s in held if s.name == name]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self, *names: str) -> None:
        """Set the counters ``names`` (every counter when none is named) to
        zero; the spans stay."""
        with self._lock:
            for name in names or list(self._counts):
                self._counts[name] = 0

    # ----- the device clock -------------------------------------------------
    def anchor(self, device, again: bool = False) -> None:
        """Tie ``device``'s event clock to the host clock: synchronise, then
        record an event on the idle device between two host readings (the
        tightest of five tries) and keep the event with the readings'
        midpoint. Once per device unless ``again``; nothing for the CPU."""
        dev = torch.device(device)
        if dev.type != "cuda" or (_index(dev) in self._anchors and not again):
            return
        with torch.cuda.device(_index(dev)):
            torch.cuda.synchronize()
            best = None
            for _ in range(5):
                ev = torch.Event("cuda", enable_timing=True)
                a = time.perf_counter_ns()
                ev.record()
                ev.synchronize()
                b = time.perf_counter_ns()
                if best is None or b - a < best[2] - best[1]:
                    best = (ev, a, b)
        ev, a, b = best
        self._anchors.setdefault(_index(dev), []).append((ev, (a + b) // 2))

    def anchors(self, device) -> List[Tuple[float, int]]:
        """Each anchor of ``device`` as (device ms since its first anchor,
        host ``perf_counter_ns``)."""
        dev = torch.device(device)
        held = self._anchors.get(_index(dev), []) if dev.type == "cuda" else []
        return [(held[0][0].elapsed_time(ev), t) for ev, t in held]

    def host_ns(self, event: torch.Event, device) -> int:
        """The ``perf_counter_ns`` at which a completed timing ``torch.Event``
        of ``device`` ran: through the first anchor, or, once there are more,
        along the line through the two anchors around it (the nearest two
        outside them), which takes out the clocks' drift."""
        points = self.anchors(device)
        first = self._anchors[_index(torch.device(device))][0][0]
        d = first.elapsed_time(event)
        if len(points) == 1:
            return points[0][1] + round(d * 1e6)
        i = min(len(points) - 2, max(0, sum(1 for x, _ in points if x <= d) - 1))
        (x0, h0), (x1, h1) = points[i], points[i + 1]
        return h0 + round((d - x0) * (h1 - h0) / (x1 - x0))


def _index(dev: torch.device) -> int:
    return torch.cuda.current_device() if dev.index is None else dev.index


RECORDER = Recorder()
span = RECORDER.span
open_span = RECORDER.open_span
count = RECORDER.count
spans = RECORDER.spans
counters = RECORDER.counters
reset = RECORDER.reset
anchor = RECORDER.anchor
anchors = RECORDER.anchors
host_ns = RECORDER.host_ns


def _first_tensor(tree):
    if torch.is_tensor(tree):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for el in tree:
            leaf = _first_tensor(el)
            if leaf is not None:
                return leaf
    return None


def force_fetch(tree) -> None:
    """Wait for every piece of work whose outputs appear in ``tree`` by
    copying one leaf of each top-level element to the host. A list or tuple
    counts element by element (results of separate launches); anything else
    is one element."""
    for el in tree if isinstance(tree, (list, tuple)) else [tree]:
        leaf = _first_tensor(el)
        if leaf is not None:
            leaf.cpu()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, device=None):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's when ``device`` is one) and write ``trace.json`` into ``logdir``
    (default: ``dctorch_trace`` under the temporary directory) on exit; open
    it in ``chrome://tracing`` or Perfetto. Yields the profiler, whose
    ``key_averages()`` hold the sums by operation once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    logdir = logdir or os.path.join(tempfile.gettempdir(), "dctorch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock time per stage. The device is synchronized
    before the clock starts and before it stops, so a stage is charged the
    device work it launched and nothing that was still running before it.
    Each stage is a span of the port's recorder whose step id is this
    timer's; ``totals`` and ``counts`` sum the spans the recorder holds."""

    _serial = itertools.count(1)

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.id = f"StageTimer-{next(self._serial)}"

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        with span(name, self.id):
            yield
            self._sync()

    def _mine(self) -> List[Span]:
        return [s for s in spans() if s.step == self.id]

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage."""
        out: Dict[str, float] = {}
        for s in self._mine():
            out[s.name] = out.get(s.name, 0.0) + (s.t1 - s.t0) / 1e9
        return out

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self._mine():
            out[s.name] = out.get(s.name, 0) + 1
        return out

    def report(self) -> str:
        totals, counts = self.totals, self.counts
        return "\n".join(
            f"{name:24s} {totals[name] / counts[name] * 1000:8.2f} ms/call "
            f"({counts[name]} calls)" for name in totals)


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Bytes in use, their peak, the bytes the allocator holds, the free
    bytes and the limit of a CUDA device; None for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(dev)
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            "bytes_free": int(free), "bytes_limit": int(total)}
