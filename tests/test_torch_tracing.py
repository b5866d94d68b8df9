"""The port's recorder (``deepcharuco_tpu_torch.profiling``) on the CPU.

Spans nest under their parents and share their step ids, the ring keeps
its bound, counters add up across threads, ``record_function`` is entered
only while a profiler records (and then the program's names are host events
of the profile), the recorder neither synchronises nor creates device
events without ``device=True``; the servers record one ``serving.step`` per
step with its pull, stage, launch and fetch under the same id and count
rows, padding and the launches made ahead of a hand-out; a training step
records its three phases once each."""

import sys
import threading
import time
import types
from functools import partial

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch import profiling, serving
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.models import Detector
from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline
from deepcharuco_tpu_torch.serving import (DeviceQueueServer, StreamServer, VideoStream,
                                           pipelined_map)
from deepcharuco_tpu_torch.train import create_detector_state, make_detector_train_step
from deepcharuco_tpu_torch.weights import variables_from_npz

H, W = 64, 96
LENGTHS = (4, 2, 1)
CHILDREN = ("serving.pull", "serving.stage", "serving.launch", "serving.fetch")
PIPELINE = ("pipeline.detector", "pipeline.decode", "pipeline.patches", "pipeline.refinenet",
            "pipeline.pose")


@pytest.fixture(scope="module")
def pipe():
    K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1]], np.float32)
    return InferencePipeline(default_config(), variables_from_npz("artifacts/detector_devsynth.npz"),
                             variables_from_npz("artifacts/refinenet_devsynth.npz"),
                             camera=Camera(K=K, dist=np.zeros(5, np.float32)),
                             compute_dtype=torch.float32, device="cpu")


def _frames():
    rng = np.random.default_rng(0)
    return [[rng.integers(0, 255, (H, W), np.uint8) for _ in range(n)] for n in LENGTHS]


def _streams():
    return [VideoStream(f) for f in _frames()]


def _since(t0, name=None):
    return [s for s in profiling.spans(name) if s.t0 >= t0]


def _delta(before, name):
    return profiling.counters().get(name, 0) - before.get(name, 0)


def test_spans_nest_under_their_parents_and_share_their_ids():
    rec = profiling.Recorder()
    with rec.span("a", 7) as a:
        with rec.span("b") as b:
            with rec.span("c", 9) as c:
                pass
        step = rec.open_span("serving.step", 3)
        with step.child("serving.pull") as pull:
            with rec.span("inner") as inner:
                pass
    step.close()
    assert (b.parent, b.step) == (a, 7) and (c.parent, c.step) == (b, 9)
    assert a.parent is None and step.parent is a and step.step == 3
    assert (pull.parent, pull.step) == (step, 3) and (inner.parent, inner.step) == (pull, 3)
    assert [s.name for s in rec.spans()] == ["c", "b", "inner", "serving.pull", "a",
                                            "serving.step"]
    assert all(s.t0 <= s.t1 for s in rec.spans())
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= a.t1
    with rec.span("after") as after:        # nothing left open on this thread
        pass
    assert after.parent is None and rec.spans("b") == [b]


def test_overlapping_open_spans_close_in_any_order():
    rec = profiling.Recorder()
    with rec.span("outer") as outer:
        first = rec.open_span("serving.step", 0)
        second = rec.open_span("serving.step", 1)
        with second.child("serving.stage") as stage:
            pass
        first.close()
        with first.child("serving.fetch") as late:
            pass
        second.close()
        with rec.span("x") as x:
            pass
    assert first.parent is outer and second.parent is outer and x.parent is outer
    assert (stage.parent, stage.step) == (second, 1) and (late.parent, late.step) == (first, 0)


def test_the_ring_keeps_its_bound():
    rec = profiling.Recorder(capacity=4)
    for i in range(10):
        with rec.span("s", i):
            pass
    assert [s.step for s in rec.spans()] == [6, 7, 8, 9]
    assert profiling.RING_SPANS >= 1 << 16


def test_counters_add_up_across_threads():
    rec = profiling.Recorder()
    rec.count("a")
    rec.count("a", 4)
    rec.count("b", 2)
    assert rec.counters() == {"a": 5, "b": 2}
    rec.reset("a")
    assert rec.counters() == {"a": 0, "b": 2}
    rec.reset()
    assert rec.counters() == {"a": 0, "b": 0}

    parents = []

    def work(k):
        with rec.span("t", k) as t:
            for _ in range(2000):
                rec.count("shared")
            with rec.span("u") as u:
                parents.append(u.parent is t and u.step == k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters()["shared"] == 16 * 2000 and parents == [True] * 16


def test_no_record_function_and_no_device_call_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("called with no profiler running")

    for mod, name in ((torch.profiler, "record_function"), (torch.cuda, "synchronize"),
                      (torch.cuda, "Event"), (torch, "Event"), (torch.Tensor, "cpu"),
                      (torch.Tensor, "item")):
        monkeypatch.setattr(mod, name, refuse)
    rec = profiling.Recorder()
    with rec.span("a", 1) as a:
        rec.open_span("b").close()
    rec.count("c")
    rec.anchor("cpu")
    assert rec.anchors("cpu") == [] and profiling.anchors("cpu") == []
    assert a.ev0 is None and a.ev1 is None and rec.spans("b")[0].parent is a


def test_under_the_profiler_spans_are_host_events():
    from torch.profiler import ProfilerActivity, profile

    rec = profiling.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("serving.pull", 0):
            torch.ones(8).sum()
        step = rec.open_span("serving.step", 1)
        with step.child("serving.fetch"):
            pass
        step.close()
    names = [e.name for e in prof.events()]
    for name in ("serving.pull", "serving.step", "serving.fetch"):
        assert names.count(name) == 1, name


def _check_steps(t0, n_steps, n_pipeline):
    steps = [s for s in _since(t0, "serving.step") if any(
        c.parent is s for c in _since(t0, "serving.launch"))]
    assert len(steps) == n_steps
    assert [s.step for s in steps] == list(range(n_steps))
    spans = _since(t0)
    for step in steps:
        kids = [s for s in spans if s.parent is step]
        assert sorted(k.name for k in kids) == sorted(CHILDREN)
        assert all(k.step == step.step and step.t0 <= k.t0 <= k.t1 <= step.t1 for k in kids)
        launch = next(k for k in kids if k.name == "serving.launch")
        under = [s for s in spans if s.parent is launch]
        assert {s.name for s in under} == set(PIPELINE[:n_pipeline])
        assert all(s.step == step.step for s in under)
    return steps


@pytest.mark.parametrize("server", ["stream", "queue"])
def test_servers_record_one_step_per_step_and_count_rows(pipe, server):
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    if server == "stream":
        out = list(StreamServer(pipe, _streams(), with_pose=True).run())
        launches, rows = max(LENGTHS), sum(LENGTHS)
    else:
        out = list(DeviceQueueServer(pipe, _streams(), chunk=3, with_pose=True).run())
        launches, rows = 2, sum(LENGTHS)
    assert len(out) == max(LENGTHS)
    capacity = len(LENGTHS) * (1 if server == "stream" else 3)
    _check_steps(t0, launches, len(PIPELINE))
    assert _delta(before, "serving.steps") == max(LENGTHS)
    assert _delta(before, "serving.rows") == rows
    assert _delta(before, "serving.padded_rows") == launches * capacity - rows
    assert _delta(before, "pipeline.frames") == launches * capacity
    assert _delta(before, "kernels.pnp_launches") == 0        # no kernel on the CPU


@pytest.mark.parametrize("source", ["ready", "busy", "gated"])
@pytest.mark.parametrize("server", ["stream", "queue"])
def test_launches_ahead_of_a_hand_out_are_counted(pipe, monkeypatch, server, source):
    """``serving.launched_ahead`` with sources that are always ready: at
    most one fewer than the launches (whether the next frames are pulled
    before a step's results are in is the threads' timing); exactly that
    on a card that finishes a step only once the next one is launched (the
    last after 5 s); none when each step's frames come only once the step
    before has been received (the block before, chunked). Each step keeps
    its four children either way."""
    chunk = 1 if server == "stream" else 3
    launches = max(LENGTHS) if server == "stream" else 2
    cond, received = threading.Condition(), [0]

    def gated(frames):
        for i, f in enumerate(frames):
            with cond:
                assert cond.wait_for(lambda: received[0] >= i // chunk * chunk, 5.0), i
            yield f

    streams = [VideoStream(gated(f) if source == "gated" else f) for f in _frames()]
    if source == "busy":
        finished = []

        def download(lane, outs):
            if finished:
                finished[-1].set()
            finished.append(threading.Event())
            return list(outs), types.SimpleNamespace(synchronize=partial(finished[-1].wait, 5.0))

        monkeypatch.setattr(serving._Lane, "download", download)
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    run = (StreamServer(pipe, streams, with_pose=True) if server == "stream" else
           DeviceQueueServer(pipe, streams, chunk=chunk, with_pose=True)).run()
    for _ in run:
        with cond:
            received[0] += 1
            cond.notify_all()
    assert received[0] == max(LENGTHS)
    _check_steps(t0, launches, len(PIPELINE))
    ahead = _delta(before, "serving.launched_ahead")
    if source == "ready":
        assert 0 <= ahead <= launches - 1
    else:
        assert ahead == (launches - 1 if source == "busy" else 0)


def test_pipelined_map_records_one_step_per_batch(pipe):
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 255, (n, H, W), np.uint8) for n in (2, 3, 1)]
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    out = list(pipelined_map(lambda x: pipe.forward_device(x), batches, depth=2,
                             device="cpu"))
    assert [o[0].shape[0] for o in out] == [2, 3, 1]
    _check_steps(t0, 3, 4)
    assert _delta(before, "serving.steps") == 3 and _delta(before, "serving.rows") == 6
    assert _delta(before, "serving.padded_rows") == 0


def test_detector_train_step_records_each_phase_once():
    det = Detector(16, torch.float32)
    state = create_detector_state(det)
    step = make_detector_train_step()
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 48, 1)).astype(np.float32))
    loc = torch.from_numpy(rng.integers(0, 65, (2, 4, 6)).astype(np.int32))
    ids = torch.from_numpy(rng.integers(0, 17, (2, 4, 6)).astype(np.int32))
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    state, _ = step(state, images, loc, ids)
    got = [(s.name, s.step) for s in _since(t0) if s.name.startswith("train.")]
    assert got == [("train.forward", 0), ("train.backward", 0), ("train.update", 0)]
    assert _delta(before, "train.steps") == 1 and state.step == 1
