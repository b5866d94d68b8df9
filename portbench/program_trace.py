"""The port's own spans and counters (``deepcharuco_tpu_torch.profiling``)
as the per-layer readers see them.

These spans and counters are recorded inside the program, so a reader
reaches them only through the program's recorder. Readers take
the spans that began after the window opened (``run.t_start``) and ended
before the profiler started (``run.stretch.t_on``), so that no profiler
runs under them. Where the program records no such span (a checkout from
before its recorder), every function here returns None or nothing; a
reading that needs the device's events is None on the CPU.

Before the first device reading of a run, :func:`prepare` waits for the
device and takes a second anchor of its event clock (the program took the
first in set-up), so that events between them map onto the host clock
along the line through both; it prints the drift between the two clocks,
the spans in the window and the counters to standard error.
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional

import torch


def recorder():
    """The program's ``profiling`` module, or None where it has no
    recorder."""
    try:
        from deepcharuco_tpu_torch import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "RECORDER") else None


def _bounds(run):
    end = min(run.stretch.t_on, run.t_end) if run.stretch is not None else run.t_end
    return run.t_start * 1e9, end * 1e9


def window(run, name: Optional[str] = None) -> list:
    """The closed spans (named ``name``) inside the window before the
    profiler, oldest first."""
    rec = recorder()
    if rec is None:
        return []
    lo, hi = _bounds(run)
    return [s for s in rec.spans(name) if s.t0 >= lo and s.t1 <= hi]


def steps(run) -> List[Dict[str, object]]:
    """The window's served steps (or batches) in order, each as
    {span name: span} of its ``serving.step`` and the children under it."""
    rec = recorder()
    if rec is None:
        return []
    lo, hi = _bounds(run)
    held = rec.spans()
    out = {id(s): {s.name: s} for s in held
           if s.name == "serving.step" and s.t0 >= lo and s.t1 <= hi}
    for s in held:
        if s.parent is not None and id(s.parent) in out:
            out[id(s.parent)][s.name] = s
    return sorted((d for d in out.values() if "serving.launch" in d),
                  key=lambda d: d["serving.step"].t0)


def prepare(run) -> bool:
    """Ready the device readings of ``run`` once: False on the CPU or
    without a recorder."""
    rec = recorder()
    if rec is None or run.device.type != "cuda":
        return False
    if not getattr(run, "_program_trace_ready", False):
        torch.cuda.synchronize(run.device)
        rec.anchor(run.device, again=True)
        points = rec.anchors(run.device)
        if len(points) > 1:
            (x0, h0), (x1, h1) = points[-2:]
            print(f"program trace: anchor drift {((h1 - h0) - (x1 - x0) * 1e6) / 1e6:+.4f} ms "
                  f"over {(h1 - h0) / 1e9:.1f} s between the set-up anchor and one after the "
                  f"window", file=sys.stderr)
        print(f"program trace: {len(window(run))} spans in the window before the profiler, "
              f"{len(rec.spans())} held; counters {rec.counters()}", file=sys.stderr)
        run._program_trace_ready = True
    return True


def host_ms(run, name: str) -> List[float]:
    return [s.host_ms() for s in window(run, name)]


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def child_ms(run, name: str) -> List[float]:
    """Host ms of each served step's child span ``name``."""
    return [d[name].host_ms() for d in steps(run) if name in d]


def held_ms(run) -> List[float]:
    """Per step: its results ready on the device (the download's event,
    on the host clock) to the end of its ``serving.step`` (handed out)."""
    if not prepare(run):
        return []
    rec = recorder()
    return [(d["serving.step"].t1 - rec.host_ns(d["serving.step"].ev1, run.device)) / 1e6
            for d in steps(run) if d["serving.step"].ev1 is not None]


def idle_gaps(run):
    """(device ms from the first step's start to the last step's results,
    [(host ns, host ns) of each stretch from step k's results to step
    k+1's first work on the compute stream, where that is positive], their
    device ms) over the window's consecutive steps; None where nothing is
    read."""
    if not prepare(run):
        return None
    rec = recorder()
    ds = [d for d in steps(run) if d["serving.step"].ev1 is not None
          and d["serving.launch"].ev0 is not None]
    if len(ds) < 2:
        return None
    gaps, idle = [], 0.0
    for a, b in zip(ds, ds[1:]):
        if b["serving.step"].step != a["serving.step"].step + 1:
            continue
        ready, start = a["serving.step"].ev1, b["serving.launch"].ev0
        ms = ready.elapsed_time(start)
        if ms > 0:
            idle += ms
            gaps.append((rec.host_ns(ready, run.device), rec.host_ns(start, run.device)))
    total = ds[0]["serving.launch"].ev0.elapsed_time(ds[-1]["serving.step"].ev1)
    return total, gaps, idle


def overlap_ns(intervals, spans) -> int:
    """Nanoseconds of ``intervals`` [(a, b)] covered by the host intervals
    of ``spans`` (which do not overlap one another)."""
    covered = 0
    for a, b in intervals:
        for s in spans:
            lo, hi = max(a, s.t0), min(b, s.t1)
            if hi > lo:
                covered += hi - lo
    return covered
