"""The port's serving and profiling modules on the CPU.

``StreamServer``, ``DeviceQueueServer`` and ``pipelined_map`` against the
synchronous ``detect``/``detect_with_pose`` on the very batches they form
(equal, bit for bit: the servers add transfers and bookkeeping, no
arithmetic) and against each other on ragged stream lengths; the stream
bookkeeping against the JAX package's servers on the same streams; the
budget guard's cases of ``tests/test_serving.py`` with the port's own
constant; the servers' threads (a step handed out before the next frames
come, the threads stopped when the caller stops or a source raises);
``StageTimer``, ``trace``, ``device_memory_stats``."""

import itertools
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu import serving as jserving
from deepcharuco_tpu_torch import profiling, serving
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline
from deepcharuco_tpu_torch.serving import (DeviceQueueServer, StreamServer, VideoStream,
                                           check_hbm_budget, pipelined_map,
                                           two_stage_batch_ceiling)
from deepcharuco_tpu_torch.weights import variables_from_npz

CFG = default_config()
DET = "artifacts/detector_devsynth.npz"
RN = "artifacts/refinenet_devsynth.npz"
FIXTURE = "tests/data/torch_port_frames.npz"
H, W = 96, 128          # small frames: the nets are fully convolutional
GB80 = 80e9
KEYS = ("keypoints", "valid", "refined")
POSE_KEYS = KEYS + ("ok", "rvec", "tvec", "reproj_rms")


@pytest.fixture(scope="module")
def pipe():
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]], np.float32)
    return InferencePipeline(CFG, variables_from_npz(DET), variables_from_npz(RN),
                             camera=Camera(K=K, dist=np.zeros(5, np.float32)),
                             compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def stream_frames():
    """Ragged streams of crops of the fixture frames around their boards."""
    fix = np.load(FIXTURE)
    frames, kp, valid = fix["frames"], fix["keypoints_f32"], fix["valid_f32"]
    rng = np.random.default_rng(3)

    def crop():
        i = rng.integers(8)
        cx, cy = kp[i][valid[i]].mean(axis=0) + rng.integers(-8, 9, 2)
        x = int(np.clip(cx - W / 2, 0, 320 - W))
        y = int(np.clip(cy - H / 2, 0, 240 - H))
        return frames[i][y:y + H, x:x + W].copy()

    return [[crop() for _ in range(n)] for n in (5, 3, 1)]


def _streams(stream_frames):
    return [VideoStream(iter(f), name=f"s{i}") for i, f in enumerate(stream_frames)]


def _padded_steps(stream_frames):
    """The batches a server forms, step by step: (batch, stream indices)."""
    out = []
    for step in range(max(len(f) for f in stream_frames)):
        idxs = [i for i, f in enumerate(stream_frames) if step < len(f)]
        batch = np.zeros((len(stream_frames), H, W), np.uint8)
        for row, i in enumerate(idxs):
            batch[row] = stream_frames[i][step]
        out.append((batch, idxs))
    return out


def _assert_steps_equal(a, b, keys):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert sorted(ra) == sorted(rb)
        for idx in ra:
            assert sorted(ra[idx]) == sorted(keys)
            for k in keys:
                np.testing.assert_array_equal(ra[idx][k], rb[idx][k])


@pytest.mark.parametrize("with_pose", [False, True])
def test_stream_server_equals_the_synchronous_calls(pipe, stream_frames, with_pose):
    steps = list(StreamServer(pipe, _streams(stream_frames), with_pose=with_pose).run())
    keys = POSE_KEYS if with_pose else KEYS
    call = pipe.detect_with_pose if with_pose else pipe.detect
    want = []
    for batch, idxs in _padded_steps(stream_frames):
        out = call(batch)
        want.append({i: {k: o[row] for k, o in zip(keys, out)} for row, i in enumerate(idxs)})
    _assert_steps_equal(steps, want, keys)
    assert [sorted(s) for s in steps] == [[0, 1, 2], [0, 1], [0, 1], [0], [0]]
    assert steps[0][0]["keypoints"].shape == (16, 2) and steps[0][0]["valid"].shape == (16,)
    assert sum(int(r["valid"].sum()) for s in steps for r in s.values()) >= 10
    if with_pose:
        assert steps[0][0]["rvec"].shape == (3,) and steps[0][0]["ok"].shape == ()


@pytest.mark.parametrize("with_pose", [False, True])
@pytest.mark.parametrize("chunk", [2, 4])
def test_device_queue_server_matches_stream_server(pipe, stream_frames, chunk, with_pose):
    """The same steps, stream indices and values on uneven stream lengths,
    which exercise both paddings (a short step inside a chunk, a short last
    chunk). Values within 1e-5: a block is another batch size, and the
    convolutions may sum in another order."""
    ref = list(StreamServer(pipe, _streams(stream_frames), with_pose=with_pose).run())
    got = list(DeviceQueueServer(pipe, _streams(stream_frames), chunk=chunk,
                                 with_pose=with_pose).run())
    assert len(got) == len(ref) == 5
    for a, b in zip(ref, got):
        assert sorted(a) == sorted(b)
        for idx in a:
            np.testing.assert_array_equal(a[idx]["valid"], b[idx]["valid"])
            v = a[idx]["valid"]
            np.testing.assert_array_equal(a[idx]["keypoints"][v], b[idx]["keypoints"][v])
            np.testing.assert_allclose(a[idx]["refined"][v], b[idx]["refined"][v], atol=1e-5)
            if with_pose:
                assert a[idx]["ok"] == b[idx]["ok"]
                np.testing.assert_allclose(a[idx]["rvec"], b[idx]["rvec"], atol=1e-3)


def test_device_queue_block_equals_the_synchronous_call(pipe, stream_frames):
    got = list(DeviceQueueServer(pipe, _streams(stream_frames), chunk=5, with_pose=True).run())
    steps = _padded_steps(stream_frames)
    out = pipe.detect_with_pose(np.concatenate([b for b, _ in steps]))
    want = [{i: {k: o[3 * step + row] for k, o in zip(POSE_KEYS, out)}
             for row, i in enumerate(idxs)} for step, (_, idxs) in enumerate(steps)]
    _assert_steps_equal(got, want, POSE_KEYS)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        DeviceQueueServer(pipe, [], chunk=0)


def test_stream_bookkeeping_matches_the_jax_servers(stream_frames):
    """Which stream answers in which step, under both servers of both
    packages, with a stand-in pipeline that returns each frame's mean."""
    class JFake:
        det_vars = rn_vars = None
        hires_scale = 1

        def _two_stage(self, dv, rv, x):
            m = jnp.mean(x.astype(jnp.float32), axis=(1, 2))
            return m, m, m

    class TFake:
        device = torch.device("cpu")
        hires_scale = 1

        def forward_device(self, x, with_pose):
            m = x.float().mean(dim=(1, 2))
            return m, m, m

    js = lambda: [jserving.VideoStream(iter(f)) for f in stream_frames]
    pairs = [(jserving.StreamServer(JFake(), js()), StreamServer(TFake(), _streams(stream_frames))),
             (jserving.DeviceQueueServer(JFake(), js(), chunk=2),
              DeviceQueueServer(TFake(), _streams(stream_frames), chunk=2))]
    for jsrv, tsrv in pairs:
        ref, got = list(jsrv.run()), list(tsrv.run())
        assert len(ref) == len(got) == 5
        for a, b in zip(ref, got):
            assert sorted(a) == sorted(b)
            for idx in a:
                assert sorted(a[idx]) == sorted(b[idx]) == sorted(KEYS)
                np.testing.assert_allclose(a[idx]["refined"], b[idx]["refined"], rtol=1e-6)


# ------------------------------------------------------------ pull thread

class _MeanPipe:
    """A stand-in pipeline: each frame's mean, as three outputs."""
    device = torch.device("cpu")
    hires_scale = 1

    def forward_device(self, x, with_pose):
        m = x.float().mean(dim=(1, 2))
        return m, m, m


SERVERS = {"stream": lambda p, s: StreamServer(p, s),
           "queue": lambda p, s: DeviceQueueServer(p, s, chunk=2)}
CHUNK = {"stream": 1, "queue": 2}
GATE_S = 5.0


def _within(fn, seconds=20.0):
    """``fn()``'s result, or a failure once it has run ``seconds``."""
    out = {}

    def work():
        try:
            out["value"] = fn()
        except BaseException as e:
            out["error"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _server_threads():
    return {t for t in threading.enumerate() if t.name in ("serving.pull", "serving.ready")}


class _Gate:
    """Frames that a source may release only once the consumer has received
    every step of the block before theirs (``chunk`` steps a block): frame
    k+1 of a stream comes after step k under ``chunk`` 1. A source that
    waits longer than ``GATE_S`` raises."""

    def __init__(self, chunk):
        self.chunk = chunk
        self.received = 0
        self.cond = threading.Condition()

    def source(self, frames):
        for i, f in enumerate(frames):
            need = i // self.chunk * self.chunk
            with self.cond:
                if not self.cond.wait_for(lambda: self.received >= need, GATE_S):
                    raise TimeoutError(f"frame {i} waited {GATE_S} s for step {need - 1}")
            yield f

    def consume(self, steps):
        out = []
        for res in steps:
            out.append(res)
            with self.cond:
                self.received += 1
                self.cond.notify_all()
        return out


@pytest.mark.parametrize("server", sorted(SERVERS))
def test_a_step_is_handed_out_before_the_next_frames_come(stream_frames, server):
    """Each stream's next frames come only once the consumer holds the step
    before (the block before under chunking): every step still comes out,
    as it does from sources that never wait. Handing a step out after the
    next step's pull would wait for the gate until it gives up."""
    threads_before = _server_threads()
    make = SERVERS[server]
    want = list(make(_MeanPipe(), _streams(stream_frames)).run())
    gate = _Gate(CHUNK[server])
    before = profiling.counters()
    got = _within(lambda: gate.consume(make(_MeanPipe(), [
        VideoStream(gate.source(f)) for f in stream_frames]).run()))
    assert len(got) == len(want) == 5
    _assert_steps_equal(got, want, KEYS)
    assert profiling.counters().get("serving.launched_ahead", 0) == before.get(
        "serving.launched_ahead", 0)
    assert _server_threads() <= threads_before


@pytest.mark.parametrize("server", sorted(SERVERS))
def test_steps_keep_their_order_when_the_threads_switch_often(server):
    """Eight servers at once, each with its two threads, over 40 steps of
    ready frames, the interpreter switching threads every microsecond:
    every server's steps come out whole and in order."""
    threads_before = _server_threads()
    rng = np.random.default_rng(7)
    streams = [[rng.integers(0, 255, (4, 4), np.uint8) for _ in range(40 - i)]
               for i in range(3)]
    want = [{i: float(np.mean(s[k])) for i, s in enumerate(streams) if k < len(s)}
            for k in range(40)]
    got = [None] * 8

    def serve(j):
        got[j] = [{i: float(r["refined"]) for i, r in res.items()} for res in SERVERS[server](
            _MeanPipe(), [VideoStream(iter(s)) for s in streams]).run()]

    threads = [threading.Thread(target=serve, args=(j,), daemon=True) for j in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for steps in got:
        assert steps is not None and len(steps) == 40
        for res, ref in zip(steps, want):
            assert sorted(res) == sorted(ref)
            np.testing.assert_allclose([res[i] for i in ref], list(ref.values()), rtol=1e-6)
    assert _server_threads() <= threads_before


@pytest.mark.parametrize("server", sorted(SERVERS))
def test_closing_the_generator_stops_the_threads(stream_frames, server):
    """An endless source that is always ready: the pull thread is ahead,
    waiting for its step's launch, when the caller stops after one step."""
    threads_before = _server_threads()
    frame = stream_frames[0][0]

    def first_step():
        steps = SERVERS[server](_MeanPipe(), [VideoStream(itertools.repeat(frame))
                                              for _ in range(2)]).run()
        res = next(steps)
        time.sleep(0.05)        # let the pull thread run ahead
        steps.close()
        return res

    res = _within(first_step)
    assert sorted(res) == [0, 1]
    np.testing.assert_allclose(res[1]["refined"], frame.mean(), rtol=1e-6)
    assert _server_threads() <= threads_before


@pytest.mark.parametrize("server", sorted(SERVERS))
def test_a_source_that_raises_reaches_the_caller(stream_frames, server):
    """The steps pulled before the failure come out, then the source's own
    exception; the server's threads are gone."""
    threads_before = _server_threads()

    def failing():
        yield from stream_frames[0][:2]
        raise OSError("camera unplugged")

    got = []

    def drain():
        streams = [VideoStream(failing())] + _streams(stream_frames)[1:]
        with pytest.raises(OSError, match="camera unplugged"):
            for res in SERVERS[server](_MeanPipe(), streams).run():
                got.append(res)

    _within(drain)
    assert [sorted(r) for r in got] == [[0, 1, 2], [0, 1]]
    assert _server_threads() <= threads_before


def test_pipelined_map_order_and_results(pipe, rng):
    batches = [rng.normal(size=(2, 8, 8)).astype(np.float32) for _ in range(5)]
    outs = list(pipelined_map(lambda x: x.sum(dim=(1, 2)), batches, depth=2, device="cpu"))
    ref = list(jserving.pipelined_map(jax.jit(lambda x: jnp.sum(x, axis=(1, 2))), batches))
    assert len(outs) == 5
    for b, o, r in zip(batches, outs, ref):
        assert isinstance(o, np.ndarray)
        np.testing.assert_allclose(o, b.sum(axis=(1, 2)), rtol=1e-5)
        np.testing.assert_allclose(o, r, rtol=1e-5)
    assert list(pipelined_map(lambda x: x, [], device="cpu")) == []
    # a tuple of outputs, more batches in flight than there are batches
    outs = list(pipelined_map(lambda x: (x + 1, x.sum()), batches[:2], depth=4, device="cpu"))
    assert len(outs) == 2 and isinstance(outs[0], tuple)
    np.testing.assert_array_equal(outs[1][0], batches[1] + 1)


def test_pipelined_map_over_the_pipeline_equals_detect_with_pose(pipe, stream_frames):
    batches = [b for b, _ in _padded_steps(stream_frames)]
    got = list(pipelined_map(lambda x: pipe.forward_device(x, True), batches, device="cpu"))
    for b, out in zip(batches, got):
        for a, w in zip(out, pipe.detect_with_pose(b)):
            np.testing.assert_array_equal(a, w)


def test_forward_device_takes_and_gives_tensors(pipe, stream_frames):
    x = torch.from_numpy(_padded_steps(stream_frames)[0][0])
    out = pipe.forward_device(x)
    assert len(out) == 3 and all(torch.is_tensor(t) for t in out)
    assert len(pipe.forward_device(x, with_pose=True)) == 7
    no_cam = InferencePipeline(CFG, variables_from_npz(DET), device="cpu")
    with pytest.raises(ValueError, match="built without a Camera"):
        no_cam.forward_device(x, with_pose=True)
    with pytest.raises(ValueError, match="built without a Camera"):
        next(StreamServer(no_cam, [VideoStream(iter([x[0].numpy()]))], with_pose=True).run())


# ------------------------------------------------------------ budget guard

def test_hbm_budget_guard_ceiling():
    """The guard's model with the port's constant on an 80 GB budget: the
    ceiling itself fits, one more frame is refused with the explanation and
    the suggested batch, the headline configuration is far inside."""
    bpp = serving.TWO_STAGE_BYTES_PER_PIXEL
    ceil = two_stage_batch_ceiling(480, 640, GB80)
    assert ceil == int(GB80 // (480 * 640 * bpp)) and ceil >= 256
    check_hbm_budget(ceil, 480, 640, GB80)
    with pytest.raises(ValueError, match="GB of two-stage activations") as err:
        check_hbm_budget(ceil + 1, 480, 640, GB80)
    assert f"batch <= {ceil}" in str(err.value) and "640x480" in str(err.value)
    check_hbm_budget(256, 240, 320, GB80)
    assert two_stage_batch_ceiling(240, 320, GB80) == int(GB80 // (240 * 320 * bpp))
    # no TPU's figure crossed over: the budget is the device's own memory
    assert not hasattr(serving, "V5E_HBM_BYTES")
    with pytest.raises(ValueError, match="pass hbm_bytes"):
        check_hbm_budget(1, 8, 8, device="cpu")
    with pytest.raises(ValueError, match="pass hbm_bytes"):
        two_stage_batch_ceiling(8, 8, device="cpu")


@pytest.mark.parametrize("server", ["DeviceQueueServer", "StreamServer"])
def test_device_queue_server_rejects_oversized_chunk(pipe, monkeypatch, server):
    """The server itself guards its first launch; the stream server, which
    takes no ``hbm_bytes``, against the device's memory."""
    frames = [np.zeros((480, 640), np.uint8)] * 2
    streams = [VideoStream(iter(frames), name=f"s{i}") for i in range(8)]
    if server == "DeviceQueueServer":
        budget = 200 * 480 * 640 * serving.TWO_STAGE_BYTES_PER_PIXEL  # room for 200 frames
        srv, match = (DeviceQueueServer(pipe, streams, chunk=32, hbm_bytes=budget),
                      "DeviceQueueServer chunk=32 x 8 streams")
    else:
        budget = 4 * 480 * 640 * serving.TWO_STAGE_BYTES_PER_PIXEL    # room for 4 frames
        monkeypatch.setattr(serving, "_device_bytes", lambda device: budget)
        srv, match = StreamServer(pipe, streams), "StreamServer chunk=1 x 8 streams"
    with pytest.raises(ValueError, match=match):
        next(srv.run())


def test_hbm_guard_budgets_hires_at_pooled_resolution():
    """A hi-res pipeline's detector runs on the pooled view, so a block
    that would overflow at the raw resolution passes at ``hires_scale=2``."""
    class FakeHiresPipe:
        hires_scale = 2
        device = torch.device("cpu")

        def forward_device(self, x, with_pose):
            n = x.shape[0]
            z = torch.zeros(n, 16, 2)
            return z, torch.zeros(n, 16, dtype=torch.bool), z

    frames = [np.zeros((480, 640), np.uint8)] * 4
    streams = [VideoStream(iter(frames), name=f"s{i}") for i in range(8)]
    budget = 200 * 480 * 640 * serving.TWO_STAGE_BYTES_PER_PIXEL
    steps = list(DeviceQueueServer(FakeHiresPipe(), streams, chunk=32, hbm_bytes=budget).run())
    assert len(steps) == 4 and sorted(steps[0]) == list(range(8))


@pytest.mark.parametrize("entry", ["pipelined_map", "check_hbm_budget", "StageTimer",
                                   "device_memory_stats", "trace"])
def test_serving_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "pipelined_map":
            next(pipelined_map(lambda x: x, [np.zeros(2)]))
        elif entry == "check_hbm_budget":
            check_hbm_budget(1, 8, 8)
        elif entry == "StageTimer":
            profiling.StageTimer()
        elif entry == "device_memory_stats":
            profiling.device_memory_stats()
        else:
            with profiling.trace():
                pass


# --------------------------------------------------------------- profiling

def test_stage_timer_accumulates_and_reports():
    timer = profiling.StageTimer(device="cpu")
    for _ in range(3):
        with timer.stage("detect"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with timer.stage("pose"):
        pass
    assert timer.counts == {"detect": 3, "pose": 1}
    assert timer.totals["detect"] > 0 and timer.totals["pose"] >= 0
    lines = timer.report().splitlines()
    assert len(lines) == 2 and lines[0].startswith("detect") and "(3 calls)" in lines[0]
    assert "ms/call" in lines[1]


def test_device_memory_stats_trace_and_force_fetch(tmp_path):
    assert profiling.device_memory_stats("cpu") is None
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.ones(8, 8).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert any("sum" in e.key for e in prof.key_averages())
    profiling.force_fetch([torch.ones(2), {"a": (torch.zeros(1),)}, None])
    profiling.force_fetch(torch.ones(2))
