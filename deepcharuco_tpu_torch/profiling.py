"""Tracing and timing utilities (``deepcharuco_tpu.profiling``).

- :func:`trace` — context manager around ``torch.profiler`` that writes a
  Chrome trace of host and device activity;
- :class:`StageTimer` — wall-clock time per stage, the device synchronized
  around each stage so that asynchronous launches do not hide the cost;
- :func:`device_memory_stats` — device memory in use and its limit;
- :func:`force_fetch` — wait for results by copying one leaf of each to the
  host.

Every function takes ``device``: None means the card, and without a card
that raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from deepcharuco_tpu_torch._device import resolve_device


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
    device work it launched and nothing that was still running before it."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(
            f"{name:24s} {self.totals[name] / self.counts[name] * 1000:8.2f} ms/call "
            f"({self.counts[name]} calls)" for name in self.totals)


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
