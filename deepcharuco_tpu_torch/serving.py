"""Serving: multi-stream video inference with pipelined transfers
(``deepcharuco_tpu.serving``).

N independent video streams go through one
:class:`~deepcharuco_tpu_torch.pipeline.InferencePipeline` with

- **batch aggregation**: one frame of every live stream forms one device
  batch, padded to a fixed capacity (one set of cuDNN plans per server, not
  one per batch size);
- **transfers that overlap compute**: a batch is gathered, uploaded and
  launched while the one before it may still run, and the host waits only
  for the batch it is about to hand out;
- **a pull thread**: the servers' sources block until a frame is due, so
  each server pulls its frames on a thread of its own, one step ahead of
  the launches, and hands a step out as soon as its results reach the
  host, never after the next step's frames.

:class:`DeviceQueueServer` gathers ``chunk`` steps of every stream into one
block and one launch (throughput first, ``chunk`` frame intervals of added
latency); :class:`StreamServer`, the latency-first server, is the same
server at ``chunk=1``, one batch per step. :func:`pipelined_map` pipelines a
function over batches that are already formed, on the caller's thread.

The serving loop (:func:`_serve`) waits on one queue that two threads of
the server feed (:class:`_Feeds`): the pull thread puts each step's frames,
and a ready thread, which waits on each launched step's download event,
says when the oldest step's results are on the host. The loop acts on
whichever comes first: it launches step k+1 while step k is in flight if
step k+1's frames come first (two batches in flight: an overloaded server
or frames that are all ready), and otherwise hands step k out. Nothing is
launched while two batches are in flight. The loop neither polls nor
sleeps: a timed wait can oversleep by a millisecond, and a loop that spins
keeps the interpreter lock from the pull thread.

How the overlap is made on the card (:class:`_Lane`). A pageable numpy
batch does not upload asynchronously, so frames are gathered straight into
pinned staging buffers (as many as batches in flight, reused; an event
guards the reuse) and uploaded on a copy stream; the compute stream waits on
the upload's event. Each batch's device-to-host copies go into pinned host
tensors on the compute stream, right behind its compute, and an event is
recorded after them: in stream order nothing later can overwrite an output
before its copy has read it, even once the output's memory is freed and
handed to the next batch. Handing a batch out waits on its event and on
nothing else. On the CPU the same code runs without streams, and a
launched batch is ready.

Spans (``profiling``), one set per step or batch, under its id:
``serving.step`` from the first pull to the hand-out, its device end the
download's event (the results ready on the host); under it
``serving.pull`` (frames from the sources, on the pull thread: the wait
for the cameras, which starts once the step before has been launched),
``serving.stage`` (the gather into pinned staging, its wait for
the buffer included, and the upload's enqueue), ``serving.launch`` (the
pipeline's enqueue and the downloads'; on the card its start event is the
step's first work on the compute stream) and ``serving.fetch`` (the host
blocked on the results). Counters: ``serving.steps`` handed out,
``serving.rows`` of frames, ``serving.padded_rows`` of padding and
``serving.launched_ahead``, the launches made while an earlier step had not
been handed out yet.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch._device import resolve_device

# Peak bytes of device memory per input pixel that served two-stage batches
# take above what the pipeline holds at rest, bf16, default (heads + decode)
# path. Measured with torch.cuda.max_memory_allocated by chip_smoke.py (phase
# 12) on an NVIDIA H100 80GB HBM3, 700.00 W: 391.1 bytes per pixel, for 256
# frames of 240×320 and for 64 frames of 480×640 alike. Rounded up.
TWO_STAGE_BYTES_PER_PIXEL = 400

RESULT_KEYS = ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "reproj_rms")


def _device_bytes(device) -> Optional[int]:
    """Total memory of a CUDA device; None for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def _budget(hbm_bytes: Optional[float], device) -> float:
    if hbm_bytes is None:
        hbm_bytes = _device_bytes(resolve_device(device))
        if hbm_bytes is None:
            raise ValueError("the CPU has no device memory to budget: pass hbm_bytes")
    return hbm_bytes


def two_stage_batch_ceiling(h: int, w: int, hbm_bytes: Optional[float] = None,
                            device=None) -> int:
    """The largest two-stage batch of (h, w) frames that fits ``hbm_bytes``
    of device memory (None → the total memory of ``device``, None → the
    card) under the measured footprint ``TWO_STAGE_BYTES_PER_PIXEL``."""
    return int(_budget(hbm_bytes, device) // (h * w * TWO_STAGE_BYTES_PER_PIXEL))


def check_hbm_budget(batch: int, h: int, w: int, hbm_bytes: Optional[float] = None,
                     context: str = "", device=None) -> None:
    """Fail fast when a two-stage batch cannot fit the device's memory:
    ``ValueError`` with the estimate, the ceiling and a suggested batch, in
    place of an allocation error in the middle of a run. ``hbm_bytes`` None →
    the total memory of ``device`` (None → the card)."""
    hbm_bytes = _budget(hbm_bytes, device)
    est = batch * h * w * TWO_STAGE_BYTES_PER_PIXEL
    if est <= hbm_bytes:
        return
    ceiling = two_stage_batch_ceiling(h, w, hbm_bytes)
    raise ValueError(
        f"{context or 'two-stage batch'} of {batch} frames @ {w}x{h} needs "
        f"~{est / 1e9:.1f} GB of two-stage activations, over the "
        f"{hbm_bytes / 1e9:.2f} GB of device memory "
        f"({TWO_STAGE_BYTES_PER_PIXEL} bytes per pixel measured). Largest batch that "
        f"fits at this resolution: ~{ceiling}. Lower the batch, the chunk or the "
        f"stream count so that batch <= {ceiling}.")


class _Lane:
    """Upload → compute → download of batches in flight on one device, the
    host waiting only in :meth:`fetch` (and in :meth:`stage` for a staging
    buffer whose last upload has not left it yet, which with ``depth``
    buffers for ``depth`` batches in flight it has)."""

    def __init__(self, device, depth: int = 2):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._depth = depth
        self._turn = 0
        self._staging: List[Optional[torch.Tensor]] = [None] * depth
        self._uploaded: List[Optional["torch.cuda.Event"]] = [None] * depth
        self._copy_stream = torch.cuda.Stream(self.device) if self.cuda else None
        profiling.anchor(self.device)

    def stage(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """The next staging buffer as a numpy array to gather frames into
        (its content is undefined). On the card it is pinned memory."""
        if not self.cuda:
            self._staged = torch.from_numpy(np.empty(shape, dtype))
            return self._staged.numpy()
        slot = self._turn % self._depth
        self._turn += 1
        if self._uploaded[slot] is not None:
            self._uploaded[slot].synchronize()
        buf = self._staging[slot]
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != tdtype:
            buf = self._staging[slot] = torch.empty(shape, dtype=tdtype, pin_memory=True)
        self._staged, self._slot = buf, slot
        return buf.numpy()

    def upload(self) -> torch.Tensor:
        """The staged batch on the device. On the card the copy runs on the
        copy stream and the current (compute) stream waits for it."""
        if not self.cuda:
            return self._staged
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            x = self._staged.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        self._uploaded[self._slot] = done
        compute.wait_event(done)
        x.record_stream(compute)    # allocated on the copy stream, read on this one
        return x

    def download(self, outs: Sequence[torch.Tensor]):
        """Enqueue the copies of ``outs`` to the host behind the work that
        makes them; returns what :meth:`fetch` takes."""
        if not self.cuda:
            return list(outs), None
        with torch.cuda.device(self.device):
            host = [t.to("cpu", non_blocking=True) for t in outs]     # pinned
            # the step's results-ready mark, read against the spans' events:
            # timing, and a torch.Event like theirs
            done = torch.Event("cuda", enable_timing=True)
            done.record()
        return host, done

    def launch(self, step: "profiling.Span", fn: Callable, *args):
        """``fn(*args)`` and its outputs' downloads, enqueued under
        ``step``'s ``serving.launch``; the download's event becomes
        ``step``'s device end. Returns (the outputs, what :meth:`fetch`
        takes)."""
        with step.child("serving.launch", device=self.cuda):
            out = fn(*args)
            pending = self.download(_as_tuple(out))
        step.ev1 = pending[1]
        return out, pending

    @staticmethod
    def fetch(pending) -> List[np.ndarray]:
        host, done = pending
        if done is not None:
            done.synchronize()
        return [t.numpy() for t in host]

    @staticmethod
    def hand_out(step: "profiling.Span", pending) -> List[np.ndarray]:
        """:meth:`fetch` under ``step``'s ``serving.fetch``; ``step`` ends."""
        with step.child("serving.fetch"):
            host = _Lane.fetch(pending)
        step.close()
        return host


def _as_tuple(out):
    return (out,) if torch.is_tensor(out) else tuple(out)


def pipelined_map(fn: Callable, batches: Iterable[np.ndarray], depth: int = 2,
                  device=None) -> Iterator:
    """Apply ``fn`` (a device tensor in, a tensor or a tuple of tensors on
    the device out, nothing copied to the host inside) over an iterator of
    host batches with ``depth`` batches in flight on ``device`` (None → the
    card). Yields the results as numpy arrays, in order."""
    lane = _Lane(resolve_device(device), depth)
    q: collections.deque = collections.deque()
    it = iter(batches)
    ids = itertools.count()

    def submit() -> bool:
        step = profiling.open_span("serving.step", next(ids))
        with step.child("serving.pull"):
            host = next(it, None)
        if host is None:
            step.close()        # the batches have ended
            return False
        with step.child("serving.stage"):
            host = np.asarray(host)
            lane.stage(host.shape, host.dtype)[...] = host
            x = lane.upload()
        out, pending = lane.launch(step, fn, x)
        profiling.count("serving.rows", host.shape[0])
        q.append((step, torch.is_tensor(out), pending))
        return True

    for _ in range(depth):
        if not submit():
            break
    while q:
        step, single, pending = q.popleft()
        submit()
        host = _Lane.hand_out(step, pending)
        profiling.count("serving.steps")
        yield host[0] if single else tuple(host)


class VideoStream:
    """One video source: any iterable of BGR or gray uint8 frames of a
    fixed (H, W)."""

    def __init__(self, frames: Iterable[np.ndarray], name: str = ""):
        self._it = iter(frames)
        self.name = name
        self.done = False

    def next_frame(self) -> Optional[np.ndarray]:
        if self.done:
            return None
        try:
            return next(self._it)
        except StopIteration:
            self.done = True
            return None


def _pull_step(streams: Sequence[VideoStream]):
    """One frame of every live stream: (frames, their stream indices)."""
    frames, idxs = [], []
    for i, s in enumerate(streams):
        f = s.next_frame()
        if f is not None:
            frames.append(np.asarray(f))
            idxs.append(i)
    return frames, idxs


def _rows(host: List[np.ndarray], base: int, idxs: List[int]) -> Dict[int, dict]:
    """{stream index: result dict} of one step whose rows start at ``base``."""
    return {stream: {key: arr[base + row] for key, arr in zip(RESULT_KEYS, host)}
            for row, stream in enumerate(idxs)}


_READY = object()       # the oldest step in flight has its results on the host


class _Feeds:
    """The two threads that feed a server's loop through one queue,
    :attr:`inbox`. The pull thread runs ``pull(k)`` for k = 0, 1, ..., each
    once the step before has been launched (:meth:`launched`), and puts what
    it returns (a step, or None once every stream has ended) or the
    exception it raised. The ready thread waits on each launched step's
    download event in turn, without the interpreter lock, and puts
    ``_READY``. :meth:`close` stops and joins both."""

    def __init__(self, pull: Callable[[int], Optional[tuple]]):
        self.inbox: queue.SimpleQueue = queue.SimpleQueue()
        self._pull = pull
        self._slot = threading.Semaphore(1)
        self._events: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = False
        self._threads = [threading.Thread(target=work, name=name, daemon=True)
                         for work, name in ((self._pulls, "serving.pull"),
                                            (self._waits, "serving.ready"))]
        for t in self._threads:
            t.start()

    def _pulls(self) -> None:
        try:
            for k in itertools.count():
                self._slot.acquire()
                if self._stop:
                    return
                got = self._pull(k)
                self.inbox.put(got)
                if got is None:
                    return
        except BaseException as e:      # raised again by the caller of run()
            self.inbox.put(e)

    def _waits(self) -> None:
        for done in iter(self._events.get, self):      # itself: the end
            try:
                if done is not None:
                    done.synchronize()
            except Exception:   # a device error: the hand-out's own wait raises it
                pass
            self.inbox.put(_READY)

    def launched(self, done) -> None:
        """A step is launched, ``done`` its download's event (None: its
        results are in): wait on it, and pull the next step."""
        self._events.put(done)
        self._slot.release()

    def close(self) -> None:
        self._stop = True
        self._slot.release()
        self._events.put(self)
        for t in self._threads:
            t.join()


def _serve(pull: Callable[[int], Optional[tuple]],
           launch: Callable[[tuple], tuple]) -> Iterator[tuple]:
    """The loop both servers run. ``pull(k)``, on the pull thread, gives
    step k's frames with its open ``serving.step`` span, or None once every
    stream has ended; ``launch(pulled)``, on this thread, enqueues them and
    returns (the span, what :meth:`_Lane.fetch` takes, what the caller
    needs back). Yields (what the caller needs back, the host arrays) of
    each step in order, at most two in flight, acting on whichever comes
    first: a step's frames (launched at once if fewer than two are in
    flight) or the oldest step's results (handed out). A source's exception
    is raised once the steps pulled before it are handed out; the threads
    are joined on every way out."""
    feeds = _Feeds(pull)
    flight: collections.deque = collections.deque()
    pulled: collections.deque = collections.deque()    # waiting for room in flight
    end = None          # True once the pull has ended, or the source's exception
    try:
        while flight or end is None:
            got = feeds.inbox.get()
            if got is _READY:
                step, pending, back = flight.popleft()
                yield back, _Lane.hand_out(step, pending)
            elif got is None or isinstance(got, BaseException):
                end = got or True
            else:
                pulled.append(got)
            while pulled and len(flight) < 2:
                if flight:
                    profiling.count("serving.launched_ahead")
                step, pending, back = launch(pulled.popleft())
                flight.append((step, pending, back))
                feeds.launched(pending[1])
        if end is not True:
            raise end
    finally:
        feeds.close()


class DeviceQueueServer:
    """Multi-stream serving in blocks: ``chunk`` consecutive frames of every
    live stream form one ``(chunk·B, H, W)`` block, padded with zero frames
    to ``chunk`` × the number of streams (one shape for the whole run: one
    set of cuDNN plans), one upload and one launch of the
    pipeline's device-level entry (``InferencePipeline.forward_device``).
    The pull thread pulls the next block while one is in flight, a block
    whose frames come first is launched first, so up to two blocks are in
    flight, and a block is handed out as soon as its results reach the host
    (:func:`_serve`). The launch's fixed costs (the host's work per batch,
    the pose kernel's launch) are shared by ``chunk`` steps at the price of
    ``chunk`` frame intervals of latency. :meth:`run` yields one dict of
    per-stream results per step. The server runs on the pipeline's device.

    The first launch is refused (``ValueError``) when the block cannot fit
    the device's memory (:func:`check_hbm_budget`; ``hbm_bytes`` None → the
    total memory of the pipeline's card, and no check on the CPU). Under a
    hi-res pipeline the detector, which holds the large activations, sees
    the pooled view, so the budget is reckoned at that resolution."""

    def __init__(self, pipeline, streams: Sequence[VideoStream], chunk: int = 8,
                 with_pose: bool = False, hbm_bytes: Optional[float] = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.pipeline = pipeline
        self.streams = list(streams)
        self.chunk = chunk
        self.with_pose = with_pose
        self.capacity = len(self.streams)
        device = resolve_device(pipeline.device)
        self.hbm_bytes = hbm_bytes if hbm_bytes is not None else _device_bytes(device)
        self._lane = _Lane(device, depth=2)

    def _pull(self, k: int):
        block = profiling.open_span("serving.step", k)
        steps = []
        with block.child("serving.pull"):
            for _ in range(self.chunk):
                frames, idxs = _pull_step(self.streams)
                if not frames:
                    break
                steps.append((frames, idxs))
        if not steps:
            block.close()       # every stream has ended
            return None
        return block, steps

    def _launch(self, pulled):
        block, steps = pulled
        first = steps[0][0][0]
        n = self.chunk * self.capacity
        if self.hbm_bytes is not None:
            s = getattr(self.pipeline, "hires_scale", 1) or 1
            check_hbm_budget(n, first.shape[0] // s, first.shape[1] // s, self.hbm_bytes,
                             context=f"{type(self).__name__} chunk={self.chunk} x "
                                     f"{self.capacity} streams")
        # short steps and a short last chunk are padded with zero frames:
        # one shape (chunk·capacity) serves the whole run
        with block.child("serving.stage"):
            staged = self._lane.stage((n, *first.shape), first.dtype)
            for step, (frames, _) in enumerate(steps):
                base = step * self.capacity
                for row, f in enumerate(frames):
                    staged[base + row] = f
                staged[base + len(frames):base + self.capacity] = 0
            staged[len(steps) * self.capacity:] = 0
            x = self._lane.upload()
        _, pending = self._lane.launch(block, self.pipeline.forward_device, x,
                                       self.with_pose)
        rows = sum(len(frames) for frames, _ in steps)
        profiling.count("serving.rows", rows)
        profiling.count("serving.padded_rows", n - rows)
        return block, pending, [idxs for _, idxs in steps]

    def run(self) -> Iterator[Dict[int, dict]]:
        """Yields {stream_index: result dict} per step until every stream
        has ended; one ``serving.step`` span covers a block, handed out with
        its first step."""
        for step_idxs, host in _serve(self._pull, self._launch):
            for step, idxs in enumerate(step_idxs):
                profiling.count("serving.steps")
                yield _rows(host, step * self.capacity, idxs)


class StreamServer(DeviceQueueServer):
    """The latency-first server: the block server at ``chunk=1``, one frame
    of every live stream per step and per launch."""

    def __init__(self, pipeline, streams: Sequence[VideoStream], with_pose: bool = False):
        super().__init__(pipeline, streams, chunk=1, with_pose=with_pose)
