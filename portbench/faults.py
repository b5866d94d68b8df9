"""Faults planted in the timed path, to show that the comparison catches
them (``tests/test_faults.py``). Each wraps a program object of the run."""

from __future__ import annotations

import torch

KEYS = ("keypoints", "valid", "refined", "ok", "rvec", "tvec", "reproj_rms")


def _forward(run, change):
    fn = run.pipe.forward_device

    def faulty(frames, with_pose=False):
        return change(list(fn(frames, with_pose)), frames, fn, with_pose)

    run.pipe.forward_device = faulty


def wrong_rows(run):
    """Refined corners handed out from the next frame's row."""
    def change(out, *_):
        out[2] = out[2].roll(1, 0)
        return tuple(out)
    _forward(run, change)


def altered_answer(run):
    """One detected corner of every frame moved by half a pixel where the
    pipeline makes it (after the pose)."""
    def change(out, *_):
        r = out[2].clone()
        first = out[1].to(torch.int8).argmax(1)
        r[torch.arange(r.shape[0], device=r.device), first, 0] += 0.5
        out[2] = r
        return tuple(out)
    _forward(run, change)


def half_batch(run):
    """Only the first half of each batch computed; its answers are handed out
    for the second half too."""
    def change(out, frames, fn, with_pose):
        n = frames.shape[0]
        h = (n + 1) // 2
        return tuple(t[torch.arange(n, device=t.device) % h] for t in out)
    _forward(run, change)


def pose_wrong_corners(run):
    """The pose of each frame solved from the next frame's corners."""
    fn = run.pipe.solve_pose
    run.pipe.solve_pose = lambda refined, valid: fn(refined.roll(1, 0), valid.roll(1, 0))


def pose_one_row(run):
    """The pose of the first frame of every batch (of every step: the
    first stream's) solved from the next frame's corners."""
    fn = run.pipe.solve_pose

    def solve(refined, valid):
        r, v = refined.clone(), valid.clone()
        r[0], v[0] = refined[1 % len(refined)], valid[1 % len(valid)]
        return fn(r, v)
    run.pipe.solve_pose = solve


def unchanged(run):
    """A training step that computes its loss and leaves the state as it
    was."""
    from deepcharuco_tpu_torch.train import detector_loss_fn

    def step(state, images, loc, ids, mesh=None):
        _, aux, _ = detector_loss_fn(state.model, images, loc, ids)
        return state, {k: v.detach() for k, v in aux.items()}
    run.step = step


def half_batch_train(run):
    """A training step on the first half of its batch only, the mean taken
    over that half."""
    fn = run.step

    def step(state, images, loc, ids, mesh=None):
        h = images.shape[0] // 2
        return fn(state, images[:h], loc[:h], ids[:h])
    run.step = step


FAULTS = {"wrong_rows": wrong_rows, "altered_answer": altered_answer,
          "half_batch": half_batch, "pose_wrong_corners": pose_wrong_corners,
          "pose_one_row": pose_one_row,
          "unchanged": unchanged, "half_batch_train": half_batch_train}


def plant(run) -> None:
    if run.fault is not None:
        FAULTS[run.fault](run)
