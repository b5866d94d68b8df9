"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips (from inside the test, via the ``card``
fixture) where there is no CUDA device. On a machine with an H100 and the
CUDA toolkit but no JAX (``tests/conftest.py`` imports JAX):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

import os
import time

import numpy as np
import pytest
import torch

from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch.ops import cuda_decode, cuda_fused
from deepcharuco_tpu_torch.ops.image import normalize_gray
from deepcharuco_tpu_torch.weights import load_detector, variables_from_npz

pytestmark = pytest.mark.cuda
N_IDS = 16
GRIDS = [(n, hc, wc) for hc, wc in ((31, 37), (29, 41)) for n in (1, 3, 256)]
FRAMES = "tests/data/torch_port_frames.npz"
DET = "artifacts/detector_devsynth.npz"


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


DECODE_CASES = ["4x30x40"] + ["x".join(map(str, g)) for g in GRIDS] + ["2x135x240",
                                                                         "signed_zero"]


def _decode_inputs(rng, case):
    """Random logits (frame 0 dustbin everywhere when there are several,
    ids on a 0.5 grid so that confidences tie), or for ``signed_zero`` id 3
    claimed with confidence −0.0 by cell 517 and ±0.0 by higher cells."""
    if case == "signed_zero":
        loc = np.zeros((3, 30, 40, 65), np.float32)
        loc[..., 64], loc[..., 5] = -10.0, 1.0
        ids = np.full((3, 30, 40, N_IDS + 1), -5.0, np.float32)
        for cell, zero in ((517, -0.0), (902, 0.0), (1100, -0.0)):
            ids[:, cell // 40, cell % 40, 3] = zero
        return loc, ids
    n, hc, wc = map(int, case.split("x"))
    loc = rng.normal(size=(n, hc, wc, 65)).astype(np.float32)
    ids = np.round(rng.normal(size=(n, hc, wc, N_IDS + 1)) * 2).astype(np.float32) / 2
    if n > 1:
        loc[0, ..., 64] = 10.0
    return loc, ids


def _twice_equal(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("min_margin", [None, 0.5])
def test_decode_kernel_matches_plain(card, rng, min_margin, case):
    loc, ids = _decode_inputs(rng, case)
    loc_t, ids_t = torch.from_numpy(loc).to(card), torch.from_numpy(ids).to(card)
    before = profiling.counters().get("kernels.b1_launches", 0)
    kk, vk = cuda_decode.decode(loc_t, ids_t, N_IDS, min_margin)
    kp, vp = cuda_decode.decode_plain(loc_t, ids_t, N_IDS, min_margin)
    torch.cuda.synchronize()
    assert profiling.counters().get("kernels.b1_launches", 0) == before + 1
    assert torch.equal(vk, vp) and torch.equal(kk, kp)
    if case == "signed_zero":      # the ±0 tie goes to the lowest cell
        assert kk[:, 3].tolist() == [[8 * (517 % 40) + 5, 8 * (517 // 40)]] * 3
    elif len(loc) > 1:
        assert not vk[0].any()
    assert _twice_equal(lambda: cuda_decode.decode(loc_t, ids_t, N_IDS, min_margin))


def _grid_trunk(card, rng, n, hc, wc):
    """The detector's trunk of n fixture frames tiled to (8·hc, 8·wc) pixels,
    under seeded lognormal noise."""
    frames = np.load(FRAMES)["frames"]
    h, w = 8 * hc, 8 * wc
    big = np.tile(frames, (1, -(-h // frames.shape[1]), -(-w // frames.shape[2])))[:, :h, :w]
    det = load_detector(DET, device=card)
    with torch.inference_mode():
        trunk = det(normalize_gray(torch.from_numpy(big[np.arange(n) % len(big)]).to(card)),
                    trunk_only=True)["trunk"]
    noise = np.exp(0.3 * rng.normal(size=tuple(trunk.shape))).astype(np.float32)
    return (trunk.float() * torch.from_numpy(noise).to(card)).to(torch.bfloat16)


# (shape, min_margin, least valid slots of the plain version)
FUSED_CASES = [((4, 30, 40), None, 16), ((4, 30, 40), 2.0, 16)] + [
    (g, None, 8) for g in GRIDS + [(1, 135, 240)]]


@pytest.mark.parametrize("shape,min_margin,least", FUSED_CASES,
                         ids=lambda p: "x".join(map(str, p)) if isinstance(p, tuple) else str(p))
def test_fused_kernel_matches_plain(card, rng, shape, min_margin, least):
    folded = cuda_fused.head_params(variables_from_npz(DET), N_IDS, card)
    trunk = _grid_trunk(card, rng, *shape)
    before = profiling.counters().get("kernels.b2_launches", 0)
    kk, vk = cuda_fused.fused_head_decode(trunk, folded, N_IDS, min_margin)
    kp, vp = cuda_fused.fused_head_decode_plain(trunk, folded, N_IDS, min_margin)
    torch.cuda.synchronize()
    assert profiling.counters().get("kernels.b2_launches", 0) == before + 1
    # the kernel and the plain version sum in different orders: near-ties
    # may flip, at most 0.5% of slots
    assert vp.sum() >= least
    assert (vk != vp).float().mean() <= 0.005
    both = vk & vp
    assert (((kk - kp).abs().amax(-1) > 0) & both).float().mean() <= 0.005
    assert _twice_equal(lambda: cuda_fused.fused_head_decode(trunk, folded, N_IDS, min_margin))


def test_wrappers_reject_bad_inputs(card):
    loc = torch.zeros(1, 30, 40, 65, device=card)
    with pytest.raises(ValueError):
        cuda_decode.decode(loc.double(), torch.zeros(1, 30, 40, 17, device=card), N_IDS)
    with pytest.raises(ValueError):
        cuda_fused.fused_head_decode(torch.zeros(1, 30, 40, 128, device=card), {}, N_IDS)
    folded = {k: v.to(card) for k, v in cuda_fused.fold_head_params(
        variables_from_npz(DET), N_IDS).items()}
    with pytest.raises(ValueError, match="head_params"):     # not packed
        cuda_fused.fused_head_decode(
            torch.zeros(1, 30, 40, 128, dtype=torch.bfloat16, device=card), folded, N_IDS)
    buf = torch.zeros(1 + 30 * 40 * 65, device=card)
    with pytest.raises(ValueError, match="aligned"):        # 4 bytes off 16
        cuda_decode.decode(buf[1:].view(1, 30, 40, 65),
                           torch.zeros(1, 30, 40, 17, device=card), N_IDS)


def test_pose_tail_graph_matches_eager(card, rng):
    """``InferencePipeline.solve_pose`` launches the pose kernel once a call:
    the poses of ``solve_pnp_plain`` within the kernel's tolerances, also
    for a second batch of the same size and for another batch size."""
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline
    from deepcharuco_tpu_torch.pnp import project_points

    fix = np.load(FRAMES)
    pipe = InferencePipeline(default_config(), variables_from_npz(DET),
                             camera=Camera(K=fix["K"], dist=fix["dist"]), device=card)
    K, dist = (torch.from_numpy(fix[k]).to(card) for k in ("K", "dist"))
    for n in (32, 32, 5):
        rvec = torch.from_numpy(rng.normal(scale=0.4, size=(n, 3)).astype(np.float32)).to(card)
        tvec = torch.from_numpy(rng.normal(scale=0.02, size=(n, 3)).astype(np.float32)).to(card)
        tvec[:, 2] += 0.3
        img = project_points(pipe.object_points, rvec, tvec, K, dist)
        valid = torch.from_numpy(rng.random((n, N_IDS)) > 0.2).to(card)
        valid[0] = False                                  # a frame with no corners
        before = profiling.counters().get("kernels.pnp_launches", 0)
        got = pipe.solve_pose(img, valid)
        torch.cuda.synchronize()
        assert profiling.counters()["kernels.pnp_launches"] == before + 1
        assert not bool(got[0][0])
        _assert_pose_agrees(pipe.object_points.cpu(), img.cpu(), valid.cpu(), fix["K"],
                            fix["dist"], got)
        assert torch.allclose(got[1][got[0]], rvec[got[0]], atol=5e-3)


# ----------------------------------------------------------- the pose kernel

PNP_K = np.array([[420.0, 0.0, 160.0], [0.0, 420.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
PNP_K_DEG = np.array([[400.0, 0, 160.0], [0, 400.0, 120.0], [0, 0, 1.0]], np.float32)
PNP_DISTS = {
    0: np.zeros(0, np.float32),
    5: np.array([0.05, -0.02, 0.001, -0.0015, 0.01], np.float32),
    8: np.array([0.12, -0.2, 0.001, -0.002, 0.05, 0.3, -0.1, 0.02], np.float32),
    12: np.array([0.1, -0.15, 0.001, -0.002, 0.03, 0.25, -0.08, 0.01,
                  0.0005, -0.0003, 0.0004, -0.0002], np.float32),
}
# the kernel against the plain solver: projections of the two poses (every
# board point) in px, and the reported reprojection RMS in px; where float32
# leaves the pose loose, the projections no further apart than the cap (twice
# the widest gap measured between two float32 solvers on real corners)
PNP_PROJ_PX, PNP_RMS_PX, PNP_PROJ_CAP_PX = 1e-3, 1e-4, 5e-2


def _board(rows=5, cols=5):
    from deepcharuco_tpu_torch.board import inner_corner_object_points
    return torch.from_numpy(inner_corner_object_points(rows, cols, 0.01))


def _pnp_poses(rng, n, max_angle=1.2, depth=(0.15, 0.5)):
    """``tests/test_torch_pnp.py``'s random poses: the board in front of the
    camera, turned up to ``max_angle`` rad."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rvec = (axis * rng.uniform(0.1, max_angle, (n, 1))).astype(np.float32)
    tvec = np.stack([rng.uniform(-0.03, 0.03, n), rng.uniform(-0.03, 0.03, n),
                     rng.uniform(*depth, n)], axis=1).astype(np.float32)
    return torch.from_numpy(rvec), torch.from_numpy(tvec)


def _pnp_project(obj, rvec, tvec, k, dist):
    from deepcharuco_tpu_torch.pnp import project_points
    return project_points(obj, rvec, tvec, torch.from_numpy(k), torch.from_numpy(dist))


def _gate_margin(img, valid):
    """The degeneracy gate's smaller principal variance minus 1 px², in
    float64 (what both solvers compare with 0 in float32)."""
    v = valid.double()
    w = v.sum(-1).clamp_min(1.0)
    x = torch.where(valid[..., None], img.double(), torch.zeros((), dtype=torch.float64))
    cen = torch.where(valid[..., None], x - (x.sum(-2) / w[..., None])[..., None, :],
                      torch.zeros((), dtype=torch.float64))
    cxx, cyy = ((cen * cen).sum(-2) / w[..., None]).unbind(-1)
    cxy = (cen[..., 0] * cen[..., 1]).sum(-1) / w
    tr, det = cxx + cyy, cxx * cyy - cxy * cxy
    return tr / 2 - torch.sqrt((tr * tr / 4 - det).clamp_min(0.0)) - 1.0


def _assert_pose_agrees(obj, img, valid, k, dist, got, iters=20, held=None):
    """The kernel's (ok, rvec, tvec, rms) on the card against
    ``solve_pnp_plain`` on the CPU on the same inputs: ``ok`` equal wherever
    the gate's margin exceeds float32 noise (1e-3 px²), failed frames zeroed
    with an infinite RMS, and on the frames of ``held`` (default: all) that
    both solve, the RMS within 1e-4 px and the two poses' projections within
    1e-3 px, or, where float32 does not pin the pose that far (corners with
    noise: two float32 solvers end up to 2.4e-2 px apart there, the plain
    one on the card and on the CPU as far as the kernel), a float64 fit of
    the corners no worse than the plain pose's by more than 1e-5 px RMS and
    projections within 5e-2 px all the same (no distant minimum of equal
    cost). Returns the widest projection and RMS gaps."""
    from chip_smoke import pose_rms64
    from deepcharuco_tpu_torch.pnp import solve_pnp_plain

    k, dist = torch.as_tensor(k), torch.as_tensor(dist)
    want = solve_pnp_plain(obj, img, valid, k, dist, iters=iters)
    ok, rvec, tvec, rms = (t.cpu() for t in got)
    assert ok.dtype == torch.bool and ok.shape == want[0].shape
    assert rvec.shape == want[1].shape and tvec.shape == want[2].shape
    clear = (_gate_margin(img, valid).abs() > 1e-3) | (valid.sum(-1) < 4)
    assert torch.equal(ok[clear], want[0][clear])
    assert (rvec[~ok] == 0).all() and (tvec[~ok] == 0).all() and torch.isinf(rms[~ok]).all()
    assert torch.isfinite(rvec).all() and torch.isfinite(tvec).all()
    both = ok & want[0] & (True if held is None else held)
    if not both.any():
        return 0.0, 0.0
    proj = lambda r, t: _pnp_project(obj.double(), r[both].double(), t[both].double(),
                                     k.double().numpy(), dist.double().numpy())
    px = (proj(rvec, tvec) - proj(want[1], want[2])).norm(dim=-1).amax(-1)
    fit = lambda r, t: pose_rms64(obj, img[both], valid[both], k, dist, r[both], t[both])
    no_worse = fit(rvec, tvec) <= fit(want[1], want[2]) + 1e-5
    drms = float((rms[both] - want[3][both]).abs().max())
    assert ((px <= PNP_PROJ_PX) | no_worse).all() and drms <= PNP_RMS_PX, (px.max(), drms)
    assert (px <= PNP_PROJ_CAP_PX).all(), px.max()
    return float(px.max()), drms


def _pnp_cpu_cases():
    """``tests/test_torch_pnp.py``'s exact, noisy, edge and rational-model
    cases, projected by the port's camera model: (name, obj, img, valid, K,
    dist, iters, the frames whose pose is held). The edge case's frame 6
    (four points, three in line on the board) is held to ``ok`` only: its
    AᵀA has a two-dimensional null space, so the DLT's start there is
    rounding's choice in any float32 solver (the CPU test leaves its ``ok``
    open too), and so is the minimum it leads to."""
    obj = _board()
    rng = np.random.default_rng(42)
    rv, tv = _pnp_poses(rng, 8)
    every = torch.ones(8, dtype=torch.bool)
    cases = [("exact", obj, _pnp_project(obj, rv, tv, PNP_K, PNP_DISTS[5]),
              torch.ones(8, 16, dtype=torch.bool), PNP_K, PNP_DISTS[5], 20, every)]
    rng = np.random.default_rng(43)
    rv, tv = _pnp_poses(rng, 8)
    img = _pnp_project(obj, rv, tv, PNP_K, PNP_DISTS[5]) + torch.from_numpy(
        rng.normal(scale=0.5, size=(8, 16, 2)).astype(np.float32))
    cases.append(("noisy", obj, img, torch.ones(8, 16, dtype=torch.bool), PNP_K,
                  PNP_DISTS[5], 30, every))
    rng = np.random.default_rng(44)
    rv, tv = _pnp_poses(rng, 8)
    img = _pnp_project(obj, rv, tv, PNP_K_DEG, np.zeros(5, np.float32)).numpy().copy()
    valid = np.ones((8, 16), bool)
    valid[0] = False
    valid[0, [0, 3, 5, 8, 12, 15]] = True
    img[0][~valid[0]] = -1e3
    valid[1] = False
    valid[1, [0, 1, 2]] = True
    img[1] = 0.0
    img[2] = 37.0
    img[3] = np.stack([np.linspace(10, 300, 16), np.linspace(10, 200, 16)], axis=1)
    valid[4, [2, 9]] = False
    img[4][~valid[4]] = np.nan
    valid[5] = False
    valid[5, [0, 3, 12, 15]] = True
    valid[6] = False
    valid[6, [0, 1, 2, 15]] = True
    valid[7] = False
    cases.append(("edge", obj, torch.from_numpy(img), torch.from_numpy(valid), PNP_K_DEG,
                  np.zeros(5, np.float32), 20, torch.arange(8) != 6))
    rng = np.random.default_rng(45)
    for n in (8, 12):
        rv, tv = _pnp_poses(rng, 8)
        cases.append((f"rational{n}", obj, _pnp_project(obj, rv, tv, PNP_K, PNP_DISTS[n]),
                      torch.ones(8, 16, dtype=torch.bool), PNP_K, PNP_DISTS[n], 20, every))
    return cases


@pytest.mark.parametrize("case", ["exact", "noisy", "edge", "rational8", "rational12"])
def test_pnp_kernel_matches_plain_on_the_cpu_tests_cases(card, case):
    from deepcharuco_tpu_torch.pnp import solve_pnp

    name, obj, img, valid, k, dist, iters, held = next(c for c in _pnp_cpu_cases()
                                                       if c[0] == case)
    got = solve_pnp(obj.to(card), img.to(card), valid.to(card), torch.from_numpy(k).to(card),
                    torch.from_numpy(dist).to(card), iters=iters)
    torch.cuda.synchronize()
    _assert_pose_agrees(obj, img, valid, k, dist, got, iters=iters, held=held)
    if case == "edge":          # the CPU test's expectations
        assert got[0].cpu().tolist()[:6] == [True, False, False, False, True, True]
        assert not bool(got[0][7])
    elif case != "noisy":
        assert bool(got[0].all()) and float(got[3].max()) < 1e-2


def _pnp_sweep(rng, m, dist, obj):
    """m frames of random poses with ~20% of the slots invalid, and among
    them a frame without corners, one with 3, a collinear one and one with
    NaN in its invalid slots."""
    rv, tv = _pnp_poses(rng, m, depth=(0.3, 0.6) if len(obj) > 16 else (0.15, 0.5))
    img = _pnp_project(obj, rv, tv, PNP_K, dist).clone()
    img += torch.from_numpy(rng.normal(scale=0.05, size=tuple(img.shape)).astype(np.float32))
    valid = torch.from_numpy(rng.random((m, len(obj))) > 0.2)
    specials = [lambda: valid[0].zero_(),
                lambda: (valid[1].zero_(), valid[1, :3].fill_(True)),
                lambda: img[2].copy_(torch.stack([torch.linspace(10, 300, len(obj)),
                                                  torch.linspace(10, 200, len(obj))], -1)),
                lambda: img[3].masked_fill_(~valid[3, :, None], float("nan"))]
    for i, change in enumerate(specials[:m]):
        change()
    return img, valid


@pytest.mark.parametrize("n_dist", sorted(PNP_DISTS))
@pytest.mark.parametrize("m", [1, 5, 56, 256])
def test_pnp_kernel_matches_plain_on_a_sweep(card, m, n_dist):
    """Batch sizes, the distortion models (the kernel always runs all 12
    coefficients), the special frames; one launch a call."""
    from deepcharuco_tpu_torch.pnp import solve_pnp

    obj = _board()
    img, valid = _pnp_sweep(np.random.default_rng(1000 * m + n_dist), m, PNP_DISTS[n_dist], obj)
    before = profiling.counters().get("kernels.pnp_launches", 0)
    got = solve_pnp(obj.to(card), img.to(card), valid.to(card),
                    torch.from_numpy(PNP_K).to(card), torch.from_numpy(PNP_DISTS[n_dist]).to(card))
    torch.cuda.synchronize()
    assert profiling.counters()["kernels.pnp_launches"] == before + 1
    _assert_pose_agrees(obj, img, valid, PNP_K, PNP_DISTS[n_dist], got)
    ok = got[0].cpu()
    assert not ok[:min(m, 3)].any()                 # no corners, 3 corners, collinear
    if m > 4:
        assert ok[3] and ok[4:].float().mean() > 0.9


def test_pnp_kernel_walks_a_54_corner_board(card):
    """A 7×10 board: 54 corners, two a lane."""
    from deepcharuco_tpu_torch.pnp import solve_pnp

    obj = _board(7, 10)
    assert len(obj) == 54
    img, valid = _pnp_sweep(np.random.default_rng(54), 56, PNP_DISTS[12], obj)
    got = solve_pnp(obj.to(card), img.to(card), valid.to(card),
                    torch.from_numpy(PNP_K).to(card), torch.from_numpy(PNP_DISTS[12]).to(card))
    torch.cuda.synchronize()
    _assert_pose_agrees(obj, img, valid, PNP_K, PNP_DISTS[12], got)
    assert got[0].cpu()[4:].float().mean() > 0.9


def test_pnp_kernel_takes_any_leading_dimensions(card):
    """One frame (N, 2) → scalars; (2, 3, N, 2) → (2, 3): each frame's
    answer as in one flat batch; an empty batch launches nothing."""
    from deepcharuco_tpu_torch.pnp import solve_pnp

    obj = _board()
    img, valid = _pnp_sweep(np.random.default_rng(7), 6, PNP_DISTS[5], obj)
    args = lambda i, v: (obj.to(card), i.to(card), v.to(card), torch.from_numpy(PNP_K).to(card),
                         torch.from_numpy(PNP_DISTS[5]).to(card))
    flat = solve_pnp(*args(img, valid))
    grid = solve_pnp(*args(img.reshape(2, 3, 16, 2), valid.reshape(2, 3, 16)))
    one = solve_pnp(*args(img[5], valid[5]))
    assert grid[0].shape == (2, 3) and grid[1].shape == (2, 3, 3) and grid[3].shape == (2, 3)
    assert one[0].shape == () and one[1].shape == (3,) and one[3].shape == ()
    for a, b, c in zip(flat, grid, one):
        assert torch.equal(a, b.reshape(a.shape)) and torch.equal(a[5], c)
    before = profiling.counters().get("kernels.pnp_launches", 0)
    empty = solve_pnp(*args(img[:0], valid[:0]))
    assert empty[0].shape == (0,) and empty[1].shape == (0, 3)
    assert profiling.counters().get("kernels.pnp_launches", 0) == before


def test_pnp_wrapper_refuses_what_the_kernel_does_not_take(card):
    from deepcharuco_tpu_torch.pnp import solve_pnp
    from deepcharuco_tpu_torch.pnp.solve import MAX_POINTS

    obj, k = _board().to(card), torch.from_numpy(PNP_K).to(card)
    img, valid = torch.zeros(4, 16, 2, device=card), torch.ones(4, 16, dtype=torch.bool, device=card)
    dist = torch.zeros(5, device=card)
    bad = [
        (img.double(), valid, obj, k, dist, 20),                       # float64 points
        (torch.zeros(4, 2, 16, device=card).transpose(1, 2), valid, obj, k, dist, 20),  # strided
        (img, valid.float(), obj, k, dist, 20),                        # mask not bool
        (img, valid[:, :15], obj, k, dist, 20),                        # mask of another shape
        (img, valid, obj[:15], k, dist, 20),                           # board of another size
        (img, valid, obj, k.cpu(), dist, 20),                          # K on another device
        (img, valid, obj, k, torch.zeros(14, device=card), 20),       # tilted-sensor model
        (img, valid, obj, k, dist, -1),                                # negative iterations
        (torch.zeros(1, MAX_POINTS + 1, 2, device=card),
         torch.ones(1, MAX_POINTS + 1, dtype=torch.bool, device=card),
         torch.zeros(MAX_POINTS + 1, 3, device=card), k, dist, 20),   # too many points
    ]
    before = profiling.counters().get("kernels.pnp_launches", 0)
    for i, args in enumerate(bad):
        with pytest.raises(ValueError):
            solve_pnp(*args[:5], iters=args[5])
    assert profiling.counters().get("kernels.pnp_launches", 0) == before


INT8 = "artifacts/detector_devsynth_int8.npz"
RN = "artifacts/refinenet_devsynth.npz"


@pytest.mark.parametrize("hw", [(64, 80), (59, 73)])
def test_int8_accumulators_on_the_card_equal_the_cpu_route(card, hw):
    """The card's integer route (im2col + ``torch._int_mm``) against the
    CPU's (int32 ``F.conv2d``), layer by layer and bit for bit, also on odd
    sizes where the pools floor and the last chunk is short."""
    from deepcharuco_tpu_torch.models.quant import QuantDetector, qvars_from_npz

    frames = np.load(FRAMES)["frames"][:3, 60:60 + hw[0], 80:80 + hw[1]]
    g = normalize_gray(torch.from_numpy(np.ascontiguousarray(frames)))
    det = QuantDetector(qvars_from_npz(INT8), N_IDS).eval()
    acc_cpu, acc_card = [], []
    with torch.inference_mode():
        out_cpu = det(g, accumulators=acc_cpu)
        out_card = det.to(card)(g.to(card), accumulators=acc_card)
    assert len(acc_card) == 12
    for i, (a, b) in enumerate(zip(acc_card, acc_cpu)):
        assert a.dtype == torch.int32 and torch.equal(a.cpu(), b), f"accumulator {i}"
    for k in out_cpu:
        assert torch.equal(out_card[k].cpu(), out_cpu[k])


def test_int8_chunks_of_frames_agree_on_the_card(card, monkeypatch):
    """One frame per chunk gives the logits and accumulators of the whole
    batch; so does a single product against the CPU's convolution on a shape
    that needs every padding (K = 9·64, N = 65)."""
    from deepcharuco_tpu_torch.models import quant

    frames = np.load(FRAMES)["frames"][:5, 40:104, 60:140]
    g = normalize_gray(torch.from_numpy(np.ascontiguousarray(frames))).to(card)
    det = quant.QuantDetector(quant.qvars_from_npz(INT8), N_IDS).eval().to(card)
    whole_acc, one_acc = [], []
    with torch.inference_mode():
        whole = det(g, accumulators=whole_acc)
        monkeypatch.setattr(quant, "_CHUNK_PIXELS", 1)
        one = det(g, accumulators=one_acc)
    assert all(torch.equal(whole[k], one[k]) for k in whole)
    assert len(one_acc) == 12 and all(torch.equal(a, b) for a, b in zip(whole_acc, one_acc))
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.integers(-128, 128, (5, 12, 16, 64), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (65, 64, 3, 3), dtype=np.int8))
    assert torch.equal(quant.qconv_acc(q.to(card), w.to(card), -128).cpu(),
                       quant.qconv_acc(q, w, -128))


@pytest.mark.parametrize("with_pose", [False, True])
def test_servers_on_the_card_equal_the_synchronous_calls(card, rng, with_pose):
    """Two batches in flight: every served result equals the synchronous
    call's on the same batch, so no output was read after the next batch
    had reused its memory."""
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline
    from deepcharuco_tpu_torch.serving import (RESULT_KEYS, DeviceQueueServer, StreamServer,
                                               VideoStream, pipelined_map)

    fix = np.load(FRAMES)
    pipe = InferencePipeline(default_config(), variables_from_npz(DET), variables_from_npz(RN),
                             camera=Camera(K=fix["K"], dist=fix["dist"]), device=card)
    steps, n = 6, 8
    batches = [np.stack([np.roll(fix["frames"][(i + s) % 8], 3 * s + i, axis=1)
                         for i in range(n)]) for s in range(steps)]
    keys = RESULT_KEYS if with_pose else RESULT_KEYS[:3]
    call = pipe.detect_with_pose if with_pose else pipe.detect
    want = [call(b) for b in batches]
    streams = lambda: [VideoStream(iter([b[i] for b in batches])) for i in range(n)]
    served = list(StreamServer(pipe, streams(), with_pose=with_pose).run())
    queued = list(DeviceQueueServer(pipe, streams(), chunk=1, with_pose=with_pose).run())
    mapped = list(pipelined_map(lambda x: pipe.forward_device(x, with_pose), batches))
    assert len(served) == len(queued) == len(mapped) == steps
    for s in range(steps):
        for j, key in enumerate(keys):
            for got in (served[s], queued[s]):
                rows = np.stack([got[i][key] for i in range(n)])
                assert np.array_equal(rows, want[s][j], equal_nan=True), (s, key)
            assert np.array_equal(mapped[s][j], want[s][j], equal_nan=True), (s, key)
    if with_pose:
        assert sum(int(w[3].sum()) for w in want) >= steps * n // 2


def test_geom_decode_on_the_card_matches_the_cpu(card):
    """The geometry decode and its fill on the same float32 logits: the same
    masks and positions on the card as on the CPU."""
    from deepcharuco_tpu_torch.board import inner_corner_object_points
    from deepcharuco_tpu_torch.ops import fill_from_homography, pred_to_keypoints_geom

    fix = np.load(FRAMES)
    det = load_detector(DET, dtype=torch.float32, device="cpu")
    xy = torch.from_numpy(inner_corner_object_points(5, 5, 0.01)[:, :2])
    noise = tuple(torch.from_numpy(fix[k]) for k in ("geom_noise_g", "geom_noise_gs"))
    with torch.inference_mode():
        out = det(normalize_gray(torch.from_numpy(fix["frames"])))
        res = {}
        for dev in ("cpu", card):
            kp, v = pred_to_keypoints_geom(out["loc"].to(dev), out["ids"].to(dev), N_IDS,
                                           xy.to(dev), noise=tuple(t.to(dev) for t in noise))
            res[str(dev)] = (kp, v, *fill_from_homography(kp, v, xy.to(dev), (240, 320)))
    a, b = res["cpu"], res[str(card)]
    assert torch.equal(a[1], b[1].cpu()) and int(a[1].sum()) >= 100      # reselected
    assert torch.equal(a[3], b[3].cpu()) and torch.equal(a[4], b[4].cpu())  # valid | filled
    assert int(a[4].sum()) >= 1
    assert torch.allclose(a[0][a[1]], b[0].cpu()[a[1]], atol=1e-4)
    assert torch.allclose(a[2][a[3]], b[2].cpu()[a[3]], atol=1e-4)


def test_profiling_on_the_card(card, tmp_path):
    stats = profiling.device_memory_stats(card)
    assert stats["bytes_limit"] >= stats["bytes_free"] > 0 and stats["bytes_in_use"] >= 0
    timer = profiling.StageTimer(card)
    x = torch.ones(2048, 2048, device=card)
    with timer.stage("matmul"):
        y = x @ x
    assert timer.totals["matmul"] > 0 and float(y[0, 0]) == 2048.0
    with profiling.trace(str(tmp_path), device=card) as prof:
        x @ x
    assert any(e.device_time_total > 0 for e in prof.key_averages())
    assert (tmp_path / "trace.json").stat().st_size > 0


def _move(d, dev):
    return {k: _move(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in d.items()}


def test_synthesis_on_the_card_renders_as_on_the_cpu(card):
    """Draws made on the card, rendered there and on the CPU: the label maps
    and the visible mask equal, the images within 1e-3 but for one-level
    flips of the low-light rounding on at most 1% of the pixels."""
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.data import device_synth as P

    kw = dict(perspective_p=0.5, axis_snap_p=0.5, low_gain_p=0.5)
    on_card = P.DeviceSynthesizer(default_config(), device=card, **kw)
    on_cpu = P.DeviceSynthesizer(default_config(), device="cpu", **kw)
    d = on_card.draw(torch.Generator(device=card).manual_seed(0), 16)
    got = [t.cpu() for t in on_card.render_full(d)]
    want = on_cpu.render_full(_move(d, "cpu"))
    for i in (1, 2, 4):
        assert torch.equal(got[i], want[i]), i
    diff = (got[0] - want[0]).abs()
    flips = (diff - 1 / 255).abs() <= 1e-3
    assert float(flips.float().mean()) <= 0.01
    assert float(torch.where(flips, 0.0, diff).max()) <= 1e-3
    fp = P.FramePatchSynthesizer(default_config(), device=card)
    p, h = fp.batch(torch.Generator(device=card).manual_seed(1), 64)
    assert p.shape == (64, 24, 24, 1) and h.shape == (64, 64, 64, 1) and p.is_cuda


def test_train_steps_on_the_card_follow_the_cpu(card, rng):
    """Three float32 Adam steps (TF32 off) on the card and on the CPU from
    the shipped detector weights: the losses within 1e-4 relative."""
    from deepcharuco_tpu_torch.models import Detector
    from deepcharuco_tpu_torch.train import create_detector_state, make_detector_train_step
    from deepcharuco_tpu_torch.weights import detector_state_dict, load_state

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sd = detector_state_dict(variables_from_npz(DET))
        images = torch.from_numpy(rng.normal(scale=0.3, size=(4, 64, 96, 1)).astype(np.float32))
        loc = torch.from_numpy(rng.integers(0, 65, size=(4, 8, 12)))
        ids = torch.from_numpy(rng.integers(0, 17, size=(4, 8, 12)))
        losses = {}
        for dev in ("cpu", card):
            state = create_detector_state(load_state(Detector(N_IDS, torch.float32), sd).to(dev))
            step = make_detector_train_step(conf_weight=0.5, conf_topk=2)
            losses[str(dev)] = [float(step(state, images.to(dev), loc.to(dev), ids.to(dev))[1]["loss"])
                                for _ in range(3)]
        for a, b in zip(losses["cpu"], losses[str(card)]):
            assert abs(a - b) <= 1e-4 * abs(a), losses
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_detector_metrics_on_the_card_launch_the_decode_kernel(card, rng):
    from deepcharuco_tpu_torch.train.metrics import detector_metrics

    loc_hat = rng.normal(size=(8, 30, 40, 65)).astype(np.float32)
    ids_hat = (np.round(rng.normal(size=(8, 30, 40, N_IDS + 1)) * 2) / 2).astype(np.float32)
    loc_t = rng.integers(0, 65, size=(8, 30, 40)).astype(np.int32)
    ids_t = rng.integers(0, N_IDS + 1, size=(8, 30, 40)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (loc_hat, ids_hat, loc_t, ids_t)]
    before = profiling.counters().get("kernels.b1_launches", 0)
    got = detector_metrics(*(a.to(card) for a in args), N_IDS)
    assert profiling.counters().get("kernels.b1_launches", 0) == before + 1
    want = detector_metrics(*args, N_IDS)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


def test_train_cli_on_the_card(card, tmp_path):
    from deepcharuco_tpu_torch.cli import train as det_cli

    det_cli.main(["--device-synth", "--steps", "2", "--eval-every", "2",
                  "--eval-batches", "1", "--batch-size", "4", "--logdir", str(tmp_path / "tb"),
                  "--ckpt-dir", str(tmp_path / "ck")])
    assert os.path.exists(tmp_path / "ck" / "step_0000002" / "variables.npz")


def test_the_anchor_puts_a_device_event_on_the_host_clock(card):
    """An event recorded on an idle card, read on the host clock through the
    anchor, lies within 0.1 ms of the host's time once it has run."""
    profiling.anchor(card)
    x = torch.ones(1 << 20, device=card)
    for _ in range(3):
        (x * 2).sum()
        torch.cuda.synchronize(card)
        ev = torch.Event("cuda", enable_timing=True)
        ev.record()
        ev.synchronize()
        t = time.perf_counter_ns()
        assert abs(t - profiling.host_ns(ev, card)) < 100_000


def test_a_steady_pose_call_records_no_capture(card):
    """Each pose call launches the pose kernel once and records one
    ``pipeline.pose`` span with its events on the stream."""
    from deepcharuco_tpu_torch.configs import default_config
    from deepcharuco_tpu_torch.pipeline import Camera, InferencePipeline

    fix = np.load(FRAMES)
    pipe = InferencePipeline(default_config(), variables_from_npz(DET), variables_from_npz(RN),
                             camera=Camera(K=fix["K"], dist=fix["dist"]), device=card)
    pipe.detect_with_pose(fix["frames"])
    for _ in range(2):
        before = profiling.counters().get("kernels.pnp_launches", 0)
        t0 = time.perf_counter_ns()
        pipe.detect_with_pose(fix["frames"])
        assert profiling.counters()["kernels.pnp_launches"] == before + 1
        pose = [s for s in profiling.spans("pipeline.pose") if s.t0 >= t0]
        assert len(pose) == 1 and pose[0].device_ms() > 0


def test_the_recorder_adds_no_synchronisation_on_the_card(card):
    x = torch.ones(1 << 20, device=card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        step = profiling.open_span("serving.step", 0)
        with step.child("serving.launch", device=True) as launch:
            y = x * 2
        step.close()
        profiling.count("serving.rows", 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(card)
    assert launch.device_ms() >= 0 and float(y[0]) == 2.0
