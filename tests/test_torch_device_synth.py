"""The port's on-card synthesis (``deepcharuco_tpu_torch.data.device_synth``)
against the JAX package's, on the CPU.

Each synthesiser renders the JAX package's own draws (repeated from the same
``PRNGKey`` by ``tests/_jax_synth_draws.py``): the label maps, the visible
mask and the sample choices must be equal exactly, the images and heatmaps
within 1e-3 (the two sides round the warp's float32 arithmetic differently;
a pixel that the rounding moves across the board's edge or a hole's would
show as a larger difference, and none does here), except for one-level
flips of the low-light model's rounding on at most 1% of the pixels. Frames are 64×96 (the
asset's small render) except where the fixture's full-size batches are
checked.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_synth_draws as JD
from deepcharuco_tpu import board as JB
from deepcharuco_tpu.configs import default_config as jax_config
from deepcharuco_tpu.data import device_synth as J
from deepcharuco_tpu_torch import board as B
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.data import device_synth as P

SMALL = (96, 64)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port_frames.npz")
IMAGE_TOL = 1e-3
FLIP_SHARE = 0.01


def to_torch(d):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
            for k, v in d.items()}


def assert_render_equal(got, want, exact, tol=IMAGE_TOL, images=None):
    """Outputs ``exact`` equal, the others within ``tol``; output ``images``
    (the normalized frames) may also differ by one gray level (1/255) on at
    most ``FLIP_SHARE`` of its pixels: the low-light model rounds to integer
    levels, and a value that the two sides' float32 rounding puts on either
    side of a half level flips."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if i in exact:
            np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
            continue
        diff = np.abs(g - w.astype(np.float32))
        if i == images:
            flips = np.abs(diff - 1 / 255) <= tol
            assert flips.mean() <= FLIP_SHARE, (flips.sum(), flips.size)
            diff = np.where(flips, 0.0, diff)
        assert diff.max() <= tol, (i, diff.max(), int((diff > tol).sum()))


# --- the board asset --------------------------------------------------------

@pytest.mark.parametrize("size", [64, 128, 240, 480, 960])
def test_board_asset_equals_the_jax_render(size):
    cfg = jax_config()
    img, corners = JB.board_image(JB.get_board(cfg), (size, size), cfg.row_count,
                                  cfg.col_count)
    gray, got_corners = B.rendered_board(default_config(), size)
    assert gray.dtype == np.uint8 and gray.shape == (size, size)
    np.testing.assert_array_equal(gray, img[..., 0])
    np.testing.assert_array_equal(got_corners, corners)
    np.testing.assert_array_equal(got_corners, B.inner_corner_pixels((size, size), 5, 5))


def test_board_asset_refuses_what_it_does_not_hold():
    """A size or a board that the asset does not store is drawn from the
    ArUco bits it holds (``tests/test_torch_board.py`` holds the drawing to
    cv2's); a dictionary whose bits it does not hold is refused."""
    gray, corners = B.rendered_board(default_config(), 100)
    assert gray.shape == (100, 100) and corners.shape == (16, 2)
    gray, corners = B.rendered_board(default_config(row_count=6), 240)
    assert gray.shape == (240, 240) and corners.shape == (20, 2)
    with pytest.raises(KeyError, match="make_torch_port_board.py"):
        B.rendered_board(default_config(board_name="DICT_NOT_THERE"), 240)


# --- renders on JAX's draws -------------------------------------------------

DET_CASES = {
    "base": dict(),
    "diet": dict(perspective_p=0.7, axis_snap_p=0.7, low_gain_p=0.7, scale_range=(0.25, 1.05)),
    "negatives": dict(negative_p=0.6, refinenet_ranges=True),
    "bank": dict(bg_bank_p=0.6),
}


@pytest.mark.parametrize("case", sorted(DET_CASES))
def test_detector_render_on_jax_draws(case):
    kw = dict(DET_CASES[case])
    if case == "bank":
        kw["bg_bank"] = np.random.default_rng(0).uniform(0, 255, (3, 100, 150)).astype(np.float32)
    js = J.DeviceSynthesizer(jax_config(input_size=SMALL), **kw)
    ps = P.DeviceSynthesizer(default_config(input_size=SMALL), device="cpu", **kw)
    key = jax.random.PRNGKey(11)
    draws = JD.draws(js, key, 6)
    want = jax.jit(jax.vmap(js._sample_full))(jax.random.split(key, 6))
    got = ps.render_full(to_torch(draws))
    assert got[0].shape == (6, 64, 96, 1) and got[1].dtype == torch.int32
    assert_render_equal([t.numpy() for t in got], want, exact=(1, 2, 4), images=0)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-4)
    if case == "negatives":
        assert draws["negative"].any() and not got[4][torch.from_numpy(draws["negative"])].any()


@pytest.mark.parametrize("patch_size,continuous,perspective_p",
                         [(24, True, 0.0), (32, False, 0.6)])
def test_frame_patch_render_on_jax_draws(patch_size, continuous, perspective_p):
    kw = dict(patch_size=patch_size, continuous_targets=continuous,
              perspective_p=perspective_p, jitter_px=2.5, per_frame=4)
    js = J.FramePatchSynthesizer(jax_config(input_size=SMALL), **kw)
    ps = P.FramePatchSynthesizer(default_config(input_size=SMALL), device="cpu", **kw)
    key = jax.random.PRNGKey(5)
    want = js.batch(key, 10)            # 2 frames of 4, the first 8 patches kept
    got = ps.render(to_torch(JD.draws(js, key, 10)), 10)
    assert got[0].shape == (8, patch_size, patch_size, 1) and got[1].shape == (8, 64, 64, 1)
    assert_render_equal([t.numpy() for t in got], want, exact=())


@pytest.mark.parametrize("patch_size,continuous", [(24, True), (32, False)])
def test_refine_render_on_jax_draws(patch_size, continuous):
    js = J.DeviceRefineSynthesizer(jax_config(input_size=SMALL), patch_size=patch_size,
                                   continuous_targets=continuous)
    ps = P.DeviceRefineSynthesizer(default_config(input_size=SMALL), device="cpu",
                                   patch_size=patch_size, continuous_targets=continuous)
    key = jax.random.PRNGKey(9)
    want = js.batch(key, 6)
    got = ps.render(to_torch(JD.draws(js, key, 6)))
    assert_render_equal([t.numpy() for t in got], want, exact=())


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files if k.startswith("synth/")}


def _fixture_synth(name):
    cfg = default_config()
    return {"det_base": lambda: P.DeviceSynthesizer(cfg, device="cpu"),
            "det_diet": lambda: P.DeviceSynthesizer(cfg, perspective_p=0.5, axis_snap_p=0.5,
                                                    low_gain_p=0.5, device="cpu"),
            "frame_patch": lambda: P.FramePatchSynthesizer(cfg, perspective_p=0.5,
                                                           device="cpu"),
            "refine": lambda: P.DeviceRefineSynthesizer(cfg, device="cpu")}[name]()


@pytest.mark.parametrize("name", ["det_base", "det_diet", "frame_patch", "refine"])
def test_fixture_batches_render_as_stored(fixture, name):
    """The full-size batches the card check (``chip_smoke.py`` phase 13)
    renders: the port on the CPU gives the stored JAX outputs, labels
    exactly, images within 1e-3 (they are stored as float16: ≤ 2.5e-4)."""
    synth = _fixture_synth(name)
    draws = P.load_draws(fixture, f"synth/{name}/draw", device="cpu")
    out = lambda k: fixture[f"synth/{name}/out/{k}"]
    if name.startswith("det"):
        got = synth.render_full(draws)
        want = [out(k) for k in ("images", "loc", "ids", "kpts", "visible")]
        assert_render_equal([t.numpy() for t in got], want, exact=(1, 2, 4), images=0)
        assert int(got[4].sum()) > 0
    else:
        got = synth.render(draws) if name == "refine" else synth.render(draws, 8)
        assert_render_equal([t.numpy() for t in got], [out("patches"), out("heatmaps")],
                            exact=())


# --- the collision rule -----------------------------------------------------

def test_label_collisions_keep_the_corner_latest_in_perm():
    """Corners 0, 1, 2 share cell (1, 2); 3 and 4 share cell (0, 0); 5 is
    invisible in that cell. XLA's scatter keeps the update applied last —
    the collider latest in ``perm`` — and so must the port."""
    hw, n_ids = (16, 32), 6
    kx = torch.tensor([[17.5, 20.0, 23.9, 1.0, 6.0, 18.0]] * 3)
    ky = torch.tensor([[9.0, 12.2, 15.0, 1.0, 2.0, 10.0]] * 3)
    visible = torch.tensor([[True] * 5 + [False]] * 3)
    perms = torch.tensor([[0, 1, 2, 3, 4, 5], [2, 1, 0, 4, 3, 5], [5, 1, 3, 2, 0, 4]])
    loc, ids = P._label_maps(kx, ky, visible, perms, hw, n_ids)
    for b in range(3):
        perm = jnp.asarray(perms[b].numpy())
        cell = torch.where(visible[b], (ky[b] / 8).int() * 4 + (kx[b] / 8).int(), 8).numpy()
        locval = ((kx[b].int() % 8) + 8 * (ky[b].int() % 8)).numpy()
        jl = jnp.full(9, 64).at[jnp.asarray(cell)[perm]].set(jnp.asarray(locval)[perm])
        ji = jnp.full(9, n_ids).at[jnp.asarray(cell)[perm]].set(perm)
        np.testing.assert_array_equal(loc[b].reshape(-1).numpy(), np.asarray(jl[:-1]))
        np.testing.assert_array_equal(ids[b].reshape(-1).numpy(), np.asarray(ji[:-1]))
    assert ids[0, 1, 2] == 2 and ids[1, 1, 2] == 0 and ids[2, 1, 2] == 0
    assert ids[0, 0, 0] == 4 and ids[1, 0, 0] == 3


# --- the port's own draws ---------------------------------------------------

def test_batches_are_determined_by_the_seed():
    synth = P.DeviceSynthesizer(default_config(input_size=SMALL), perspective_p=0.5,
                                low_gain_p=0.5, device="cpu")
    a = synth.batch(torch.Generator().manual_seed(3), 4)
    b = synth.batch(torch.Generator().manual_seed(3), 4)
    c = synth.batch(torch.Generator().manual_seed(4), 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    rs = P.DeviceRefineSynthesizer(default_config(input_size=SMALL), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(rs.batch(torch.Generator().manual_seed(1), 3),
                                                 rs.batch(torch.Generator().manual_seed(1), 3)))


def test_draw_ranges_of_the_port_generator():
    n = 4000
    synth = P.DeviceSynthesizer(default_config(input_size=SMALL), axis_snap_p=0.3,
                                perspective_p=0.4, low_gain_p=0.2, low_gain_min=0.1,
                                bg_bank=np.zeros((5, 80, 120), np.float32), device="cpu")
    d = synth.draw(torch.Generator().manual_seed(0), n)

    def within(x, lo, hi):
        x = x.float()
        assert lo <= float(x.min()) and float(x.max()) <= hi, (lo, hi, x.min(), x.max())

    def rate(mask, p):
        assert abs(float(mask.float().mean()) - p) < 0.04, (float(mask.float().mean()), p)

    a = d["affine"]
    within(a["s"], 0.25, 0.9), within(a["ang"], -2 * np.pi, 2 * np.pi)
    within(a["sh_deg"], -35, 35), within(a["t_frac"], -0.45, 0.45)
    within(a["snap_jitter"], -0.035, 0.035), rate(a["snap"], 0.3)
    rate(d["pv"][:, 0] != 0, 0.4), within(d["pv"], -8e-4, 8e-4)
    bg = d["bg"]
    within(bg["corners"], 0, 255), within(bg["cx"], 0, 96), within(bg["cy"], 0, 64)
    within(bg["r"], 8, 32), within(bg["col"], 0, 255), within(bg["sigma"], 2, 12)
    assert abs(float(bg["noise"].std()) - 1) < 0.01
    h = d["hole"]
    rate(h["apply"], 0.4), within(h["n_holes"], 1, 6), within(h["sizes"], 16, 64)
    within(h["pos"], 0, 1)
    assert set(h["n_holes"].unique().tolist()) == set(range(1, 7))
    rate(d["negative"], 0.05)
    ph = d["photo"]
    for k, p in (("contrast_on", 0.5), ("noise_on", 0.5), ("mult_on", 0.5),
                 ("bright_on", 0.5), ("blur_on", 0.6), ("gain_on", 0.2)):
        rate(ph[k], p)
    within(ph["contrast"], 0.8, 1.2), within(ph["noise_var"], 10, 50)
    within(ph["mult"], 0.95, 1.05), within(ph["bright"], -0.8, 0.35)
    within(ph["blur"], 0.3, 1.0), within(ph["gain"], 0.1, 0.6), within(ph["read_sigma"], 1, 6)
    assert torch.equal(d["perm"].sort(dim=1).values, torch.arange(16).expand(n, 16))
    bk = d["bank"]
    rate(bk["use"], 0.5), within(bk["idx"], 0, 4), within(bk["theta"], -np.pi, np.pi)
    assert set(bk["flip"].unique().tolist()) == {-1, 1}
    within(bk["cx"], 0.4 * 96, 120 - 0.4 * 96), within(bk["cy"], 0.4 * 64, 80 - 0.4 * 64)
    rs = P.DeviceRefineSynthesizer(default_config(input_size=SMALL), device="cpu")
    r = rs.draw(torch.Generator().manual_seed(0), n)
    within(r["affine"]["s"], 0.3, 0.75), within(r["affine"]["t_frac"], 0, 0)
    within(r["idx"], 0, 15), within(r["off"], -3.99, 3.99)
    assert "gain_on" not in r["photo"] and not r["affine"]["snap"].any()


def test_batch_contract_and_label_sanity():
    synth = P.DeviceSynthesizer(default_config(), device="cpu")
    images, loc, ids = synth.batch(torch.Generator().manual_seed(0), 4)
    assert images.shape == (4, 240, 320, 1) and images.dtype == torch.float32
    assert loc.shape == ids.shape == (4, 30, 40) and loc.dtype == ids.dtype == torch.int32
    assert float(images.min()) >= -128 / 255 - 1e-6 and float(images.max()) <= 127 / 255 + 1e-6
    assert ((loc == 64) == (ids == 16)).all()       # a cell holds a corner in both maps or neither
    assert int((ids < 16).sum()) > 0
    fp = P.FramePatchSynthesizer(default_config(), device="cpu")
    p, h = fp.batch(torch.Generator().manual_seed(0), 16)
    assert p.shape == (16, 24, 24, 1) and h.shape == (16, 64, 64, 1)
    assert float(h.amax(dim=(1, 2, 3)).min()) > 0.5   # every target peak lies on the grid


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (P.DeviceSynthesizer, P.FramePatchSynthesizer, P.DeviceRefineSynthesizer):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(default_config())
    with pytest.raises(RuntimeError):
        P.load_draws({}, "x")
