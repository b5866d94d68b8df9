"""On-card synthetic training data (``deepcharuco_tpu.data.device_synth``).

The whole board pipeline — affine or projective warp, paste onto a
procedural (or bank) background, coarse dropout, the photometric stack,
the label maps — is dense tensor math, so it runs on the card beside the
train step and the host supplies only a seed. The distribution, every
option and every formula are the JAX package's (its module docstring lists
the deltas against the reference's cv2 pipeline).

Two things differ in form:

- **Draws apart from the arithmetic.** Each synthesiser's :meth:`draw` makes
  every random number a batch needs from one ``torch.Generator`` (on the
  card), as a nested dict of tensors with a leading batch dimension;
  :meth:`render` is a deterministic function of those draws. The JAX
  package's own draws (from its ``PRNGKey`` split sequence) can be passed to
  :meth:`render` in their place, which is how the tests hold the two
  renders against each other.
- **Batched, not per sample.** The JAX package ``vmap``s a per-sample
  function; here each step is one set of tensor operations over the batch.
  The fixed loops over the 2 background blobs and the 6 dropout holes stay
  unrolled.

Each :meth:`batch` takes ``share=(i, k)``: the whole batch is drawn and
only share ``i`` of ``k`` is rendered (:func:`slice_draws`). Every draw has
a leading batch dimension and every sample is rendered from its own draws,
so the share is those rows of the whole batch, bit for bit: how the ranks
of a mesh each synthesize their own samples of one global batch
(``parallel.mesh.sharded_synth_train_program``).

Label-map collisions (two corners in one 8×8 cell) go to the corner that
comes *last* in the sample's random permutation, the corner XLA's scatter
keeps (``loc_flat.at[cell[perm]].set(...)`` applies the updates in order).
A CUDA scatter with duplicate indices fixes no winner, so the rule is
written out: the largest permutation position per cell
(``scatter_reduce(amax)``), then a scatter without duplicates.

The board is rendered once per size by the JAX package's cv2 renderer and
read from the port's asset (:func:`deepcharuco_tpu_torch.board.rendered_board`).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepcharuco_tpu_torch._device import resolve_device
from deepcharuco_tpu_torch.board import rendered_board
from deepcharuco_tpu_torch.configs import Config

Draws = Dict[str, object]


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def _coin(gen, shape, p, device):
    return torch.rand(shape, generator=gen, device=device) < p


def draw_affine(gen, n: int, scale_range, translate_frac, axis_snap_p: float,
                device) -> Draws:
    """The warp's draws (:func:`_affine_params`); ``snap`` is all False when
    ``axis_snap_p`` is 0."""
    return {"s": _uniform(gen, (n,), *scale_range, device),
            "ang": _uniform(gen, (n,), -2 * math.pi, 2 * math.pi, device),
            "sh_deg": _uniform(gen, (n, 2), -35.0, 35.0, device),
            "t_frac": _uniform(gen, (n, 2), *translate_frac, device),
            "snap": _coin(gen, (n,), axis_snap_p, device),
            "snap_jitter": _uniform(gen, (n,), -0.035, 0.035, device)}


def draw_procedural_bg(gen, n: int, hw: Tuple[int, int], device) -> Draws:
    """The background's draws (:func:`_procedural_bg`)."""
    h, w = hw
    return {"corners": _uniform(gen, (n, 2, 2), 0.0, 255.0, device),
            "cx": _uniform(gen, (n, 2), 0.0, w, device),
            "cy": _uniform(gen, (n, 2), 0.0, h, device),
            "r": _uniform(gen, (n, 2), h / 8.0, h / 2.0, device),
            "col": _uniform(gen, (n, 2), 0.0, 255.0, device),
            "sigma": _uniform(gen, (n,), 2.0, 12.0, device),
            "noise": torch.randn((n, h, w), generator=gen, device=device)}


def draw_bank_bg(gen, n: int, bank_shape, hw: Tuple[int, int], p: float, device) -> Draws:
    """A bank background's draws (:func:`_bank_bg`) and the per-sample
    choice between it and the procedural one."""
    nb, hb, wb = bank_shape
    h, w = hw
    return {"use": _coin(gen, (n,), p, device),
            "idx": torch.randint(0, nb, (n,), generator=gen, device=device),
            "theta": _uniform(gen, (n,), -math.pi, math.pi, device),
            "flip": torch.randint(0, 2, (n, 2), generator=gen, device=device) * 2 - 1,
            "cx": _uniform(gen, (n,), 0.4 * w, wb - 0.4 * w, device),
            "cy": _uniform(gen, (n,), 0.4 * h, hb - 0.4 * h, device)}


def draw_dropout(gen, n: int, p: float, device) -> Draws:
    """CoarseDropout's draws (:func:`_dropout_mask`)."""
    return {"apply": _coin(gen, (n,), p, device),
            "n_holes": torch.randint(1, 7, (n,), generator=gen, device=device),
            "sizes": torch.randint(16, 65, (n, 6, 2), generator=gen, device=device),
            "pos": torch.rand((n, 6, 2), generator=gen, device=device)}


def draw_photometric(gen, n: int, hw: Tuple[int, int], low_gain_p: float,
                     low_gain_range, device) -> Draws:
    """The photometric stack's draws (:func:`_photometric`); the low-gain
    ones only when ``low_gain_p`` > 0."""
    d = {"contrast_on": _coin(gen, (n,), 0.5, device),
         "contrast": _uniform(gen, (n,), 0.8, 1.2, device),
         "noise_on": _coin(gen, (n,), 0.5, device),
         "noise_var": _uniform(gen, (n,), 10.0, 50.0, device),
         "noise": torch.randn((n, *hw), generator=gen, device=device),
         "mult_on": _coin(gen, (n,), 0.5, device),
         "mult": _uniform(gen, (n,), 0.95, 1.05, device),
         "bright_on": _coin(gen, (n,), 0.5, device),
         "bright": _uniform(gen, (n,), -0.8, 0.35, device),
         "blur_on": _coin(gen, (n,), 0.6, device),
         "blur": _uniform(gen, (n,), 0.3, 1.0, device)}
    if low_gain_p > 0.0:
        d.update({"gain_on": _coin(gen, (n,), low_gain_p, device),
                  "gain": _uniform(gen, (n,), *low_gain_range, device),
                  "read_sigma": _uniform(gen, (n,), 1.0, 6.0, device),
                  "dark_noise": torch.randn((n, *hw), generator=gen, device=device)})
    return d


def share_rows(n: int, share: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """Rows [lo, hi) of share ``(i, k)`` of ``n`` rows; all of them when
    ``share`` is None or ``k`` does not divide ``n``."""
    if share is None or n % share[1]:
        return 0, n
    per = n // share[1]
    return share[0] * per, (share[0] + 1) * per


def slice_draws(d: Draws, lo: int, hi: int) -> Draws:
    """Samples ``lo`` … ``hi − 1`` of draws ``d`` (every tensor's rows)."""
    return {k: slice_draws(v, lo, hi) if isinstance(v, dict) else v[lo:hi]
            for k, v in d.items()}


# ---------------------------------------------------------------------------
# Arithmetic (batched; every draw has a leading batch dimension)
# ---------------------------------------------------------------------------

def _col(v):
    """(B,) → (B, 1, 1), to broadcast a per-sample scalar over an image."""
    return v[:, None, None]


def _bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear sample ``img`` (H, W) shared by the batch, or (B, H, W) one
    per sample, at float coordinates (B, h, w); returns (values, inbounds)."""
    h, w = img.shape[-2:]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int32).clamp(0, w - 1).long()
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.to(torch.int32).clamp(0, h - 1).long()
    y1i = (y0i + 1).clamp(0, h - 1)
    if img.ndim == 2:
        flat = img.reshape(-1)
        take = lambda yi, xi: flat[yi * w + xi]
    else:
        flat = img.reshape(img.shape[0], -1)
        take = lambda yi, xi: torch.gather(flat, 1, (yi * w + xi).reshape(
            img.shape[0], -1)).reshape(yi.shape)
    v00, v01 = take(y0i, x0i), take(y0i, x1i)
    v10, v11 = take(y1i, x0i), take(y1i, x1i)
    val = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    inb = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    return val, inb


def _affine_params(d: Draws, hw: Tuple[int, int]):
    """Forward 2×2 ``A`` (B, 2, 2) and translation ``t`` (B, 2) about the
    canvas center; with ``snap`` the rotation snaps to the nearest multiple
    of 90° (± the jitter) and the shear shrinks to ±3°."""
    h, w = hw
    ang, sh_deg = d["ang"], d["sh_deg"]
    snap = d["snap"]
    ang_snapped = torch.round(ang / (math.pi / 2)) * (math.pi / 2) + d["snap_jitter"]
    ang = torch.where(snap, ang_snapped, ang)
    sh_deg = torch.where(snap[:, None], sh_deg * (3.0 / 35.0), sh_deg)
    sh = torch.tan(sh_deg * (math.pi / 180))
    c, si = torch.cos(ang), torch.sin(ang)
    s = d["s"]
    # A = (R @ Sh)·s with R = [[c, −si], [si, c]], Sh = [[1, sh0], [sh1, 1]]
    a00 = (c + (-si) * sh[:, 1]) * s
    a01 = (c * sh[:, 0] + (-si)) * s
    a10 = (si + c * sh[:, 1]) * s
    a11 = (si * sh[:, 0] + c) * s
    A = torch.stack([torch.stack([a00, a01], -1), torch.stack([a10, a11], -1)], -2)
    cx, cy = w / 2.0, h / 2.0
    t0 = cx + d["t_frac"][:, 0] * w - (a00 * cx + a01 * cy)
    t1 = cy + d["t_frac"][:, 1] * h - (a10 * cx + a11 * cy)
    return A, torch.stack([t0, t1], -1)


def _grid(hw: Tuple[int, int], device):
    """(ys (h, 1), xs (1, w)) float32 pixel coordinates."""
    h, w = hw
    return (torch.arange(h, dtype=torch.float32, device=device)[:, None],
            torch.arange(w, dtype=torch.float32, device=device)[None, :])


def _procedural_bg(d: Draws, hw: Tuple[int, int]):
    """Low-frequency gray backgrounds (B, H, W): bilinear corner gradient +
    2 soft blobs + broadband noise, in [0, 255]."""
    h, w = hw
    dev = d["sigma"].device
    ys, xs = _grid(hw, dev)
    fy = ys / max(h - 1, 1)
    fx = xs / max(w - 1, 1)
    c = d["corners"]
    base = ((1 - fy) * ((1 - fx) * _col(c[:, 0, 0]) + fx * _col(c[:, 0, 1]))
            + fy * ((1 - fx) * _col(c[:, 1, 0]) + fx * _col(c[:, 1, 1])))
    for i in range(2):
        d2 = (xs - _col(d["cx"][:, i])) ** 2 + (ys - _col(d["cy"][:, i])) ** 2
        r = _col(d["r"][:, i])
        a = torch.where(d2 < r * r, 0.45, 0.0)
        base = base * (1 - a) + _col(d["col"][:, i]) * a
    base = base + _col(d["sigma"]) * d["noise"]
    return base.clamp(0.0, 255.0)


def _bank_bg(d: Draws, bank: torch.Tensor, hw: Tuple[int, int]):
    """Backgrounds (B, H, W) from an on-card image bank: random image,
    rotation, per-axis flip and window, edge-clamped bilinear sampling."""
    h, w = hw
    ys, xs = _grid(hw, bank.device)
    xs = (xs - w / 2.0) * d["flip"][:, 0, None, None]
    ys = (ys - h / 2.0) * d["flip"][:, 1, None, None]
    c, s = _col(torch.cos(d["theta"])), _col(torch.sin(d["theta"]))
    sx = c * xs - s * ys + _col(d["cx"])
    sy = s * xs + c * ys + _col(d["cy"])
    val, _ = _bilinear_sample(bank[d["idx"]], sx, sy)
    return val


def _dropout_mask(d: Draws, hw: Tuple[int, int]):
    """CoarseDropout: (B, H, W) bool 'hole' maps (True = punched out)."""
    h, w = hw
    ys = torch.arange(h, device=d["pos"].device)[:, None]
    xs = torch.arange(w, device=d["pos"].device)[None, :]
    sizes, pos = d["sizes"], d["pos"]
    hole = torch.zeros((pos.shape[0], h, w), dtype=torch.bool, device=pos.device)
    for i in range(6):
        sh, sw = sizes[:, i, 0], sizes[:, i, 1]
        y0 = (pos[:, i, 0] * (h - sh).float()).to(torch.int32)
        x0 = (pos[:, i, 1] * (w - sw).float()).to(torch.int32)
        inside = ((ys >= _col(y0)) & (ys < _col(y0 + sh))
                  & (xs >= _col(x0)) & (xs < _col(x0 + sw)))
        hole = hole | (inside & _col(i < d["n_holes"]))
    return hole & _col(d["apply"])


def _box3(img: torch.Tensor) -> torch.Tensor:
    """3×3 box filter with edge replication over (B, H, W)."""
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
            + p[:, 1:-1, :-2] + p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
            + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:]) / 9.0


def _photometric(d: Draws, img: torch.Tensor):
    """Gray photometric stack on (B, H, W) in [0, 255]: contrast,
    brightness, noise, multiplicative gain, a probabilistic 3×3 blur, and —
    when the draws hold them — the multiplicative low-light model (sensor
    gain, read noise, rounding to integer levels)."""
    img = (img - 128.0) * _col(torch.where(d["contrast_on"], d["contrast"], 1.0)) + 128.0
    sigma = torch.where(d["noise_on"], torch.sqrt(d["noise_var"]), 0.0)
    img = img + _col(sigma) * d["noise"]
    img = img * _col(torch.where(d["mult_on"], d["mult"], 1.0))
    img = img + _col(torch.where(d["bright_on"], d["bright"] * 255.0, 0.0))
    blur_w = _col(torch.where(d["blur_on"], d["blur"], 0.0))
    img = img * (1 - blur_w) + _box3(img) * blur_w
    img = img.clamp(0.0, 255.0)
    if "gain_on" in d:
        on = d["gain_on"]
        gain = torch.where(on, d["gain"], 1.0)
        read_sigma = torch.where(on, d["read_sigma"], 0.0)
        dark = img * _col(gain) + _col(read_sigma) * d["dark_noise"]
        img = torch.where(_col(on), torch.round(dark.clamp(0.0, 255.0)), img)
    return img


def _label_maps(kx, ky, visible, perm, hw: Tuple[int, int], n_ids: int):
    """(loc, ids) (B, Hc, Wc) int32 class maps of the visible corners. Where
    corners collide in a cell, the one latest in ``perm`` wins (XLA's
    in-order scatter); no scatter here has duplicate indices that matter."""
    h, w = hw
    hc, wc = h // 8, w // 8
    n = kx.shape[0]
    cx = (kx / 8.0).to(torch.int32).clamp(0, wc - 1)
    cy = (ky / 8.0).to(torch.int32).clamp(0, hc - 1)
    cell = torch.where(visible, cy * wc + cx, hc * wc).long()     # dummy cell last
    kxi, kyi = kx.to(torch.int32), ky.to(torch.int32)
    locval = (kxi % 8) + 8 * (kyi % 8)
    pos = torch.argsort(perm, dim=1)               # each slot's place in perm
    latest = torch.full((n, hc * wc + 1), -1, dtype=pos.dtype, device=pos.device)
    latest = latest.scatter_reduce(1, cell, pos, "amax")
    wins = pos == torch.gather(latest, 1, cell)
    target = torch.where(wins, cell, hc * wc)      # the losers go to the dummy cell
    loc = torch.full((n, hc * wc + 1), 64, dtype=torch.int32, device=kx.device)
    ids = torch.full((n, hc * wc + 1), n_ids, dtype=torch.int32, device=kx.device)
    slot = torch.arange(n_ids, dtype=torch.int32, device=kx.device).expand(n, n_ids)
    loc = loc.scatter(1, target, locval.to(torch.int32))
    ids = ids.scatter(1, target, slot)
    return loc[:, :-1].reshape(n, hc, wc), ids[:, :-1].reshape(n, hc, wc)


def _heatmaps(hp: torch.Tensor, continuous: bool):
    """Gaussian targets on the 64×64 grid at ``hp`` (..., 2), cut at
    exp(−4.6052); rounded to the grid unless ``continuous``."""
    if not continuous:
        hp = torch.round(hp)
    hx = hp[..., 0].clamp(0, 63)[..., None, None]
    hy = hp[..., 1].clamp(0, 63)[..., None, None]
    g = torch.arange(64, dtype=torch.float32, device=hp.device)
    expo = ((g[None, :] - hx) ** 2 + (g[:, None] - hy) ** 2) / 8.0
    return torch.where(expo > 4.6052, 0.0, torch.exp(-expo))


# ---------------------------------------------------------------------------
# The synthesizers
# ---------------------------------------------------------------------------

class DeviceSynthesizer:
    """Normalized detector training batches, made on the card.

    Usage::

        synth = DeviceSynthesizer(config)            # on the card
        gen = torch.Generator(device="cuda").manual_seed(0)
        images, loc, ids = synth.batch(gen, 32)
    """

    def __init__(self, config: Config, negative_p: float = 0.05,
                 refinenet_ranges: bool = False, axis_snap_p: float = 0.0,
                 bg_bank=None, bg_bank_p: float = 0.5,
                 scale_range=None, perspective_p: float = 0.0,
                 low_gain_p: float = 0.0, low_gain_min: float = 0.08, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.hw = config.input_hw
        self.n_ids = config.n_ids
        self.negative_p = negative_p
        self.axis_snap_p = axis_snap_p
        self.bg_bank = (torch.as_tensor(bg_bank, dtype=torch.float32).to(self.device)
                        if bg_bank is not None else None)
        self.bg_bank_p = bg_bank_p
        self.perspective_p = perspective_p
        self.low_gain_p = low_gain_p
        self.low_gain_min = low_gain_min
        if refinenet_ranges:
            self.scale_range, self.translate_frac, self.dropout_p = (0.3, 0.75), (0.0, 0.0), 0.0
        else:
            self.scale_range, self.translate_frac, self.dropout_p = (0.25, 0.9), (-0.45, 0.45), 0.4
        if scale_range is not None:
            self.scale_range = tuple(scale_range)

        # the board render, centered in the frame canvas
        min_r = min(config.input_size)
        gray, corners = rendered_board(config, min_r)
        h, w = self.hw
        top, left = (h - min_r) // 2, (w - min_r) // 2
        canvas = torch.zeros((h, w), dtype=torch.float32)
        canvas[top:top + min_r, left:left + min_r] = torch.from_numpy(gray).float()
        self.board = canvas.to(self.device)
        self.board_x0, self.board_y0 = left, top
        self.board_x1, self.board_y1 = left + min_r, top + min_r
        self.corners = (torch.from_numpy(corners).float()
                        + torch.tensor([left, top], dtype=torch.float32)).to(self.device)

    def draw(self, gen: torch.Generator, n: int) -> Draws:
        """Every random number of ``n`` samples, from ``gen``."""
        dev = self.device
        d = {"affine": draw_affine(gen, n, self.scale_range, self.translate_frac,
                                   self.axis_snap_p, dev),
             "pv": torch.where(_coin(gen, (n, 1), self.perspective_p, dev),
                               _uniform(gen, (n, 2), -8e-4, 8e-4, dev), 0.0),
             "bg": draw_procedural_bg(gen, n, self.hw, dev),
             "hole": draw_dropout(gen, n, self.dropout_p, dev),
             "negative": _coin(gen, (n,), self.negative_p, dev),
             "photo": draw_photometric(gen, n, self.hw, self.low_gain_p,
                                       (self.low_gain_min, 0.6), dev),
             "perm": torch.argsort(torch.rand((n, self.n_ids), generator=gen, device=dev),
                                   dim=1)}
        if self.bg_bank is not None:
            d["bank"] = draw_bank_bg(gen, n, self.bg_bank.shape, self.hw, self.bg_bank_p, dev)
        return d

    def render_full(self, d: Draws):
        """The samples of draws ``d``: (images (B, H, W, 1) normalized, loc
        and ids (B, Hc, Wc) int32, kpts (B, n_ids, 2) exact sub-pixel
        corners, visible (B, n_ids) bool)."""
        h, w = self.hw
        A, t = _affine_params(d["affine"], self.hw)
        pv = d["pv"]
        cx, cy = w / 2.0, h / 2.0
        d0 = 1.0 - (pv[:, 0] * cx + pv[:, 1] * cy)
        # x_d = (A·x_s + t) / (pv·x_s + d0): invert the 3×3 homography
        m = torch.stack([torch.stack([A[:, 0, 0], A[:, 0, 1], t[:, 0]], -1),
                         torch.stack([A[:, 1, 0], A[:, 1, 1], t[:, 1]], -1),
                         torch.stack([pv[:, 0], pv[:, 1], d0], -1)], -2)
        hinv = _inv3(m)
        ys, xs = _grid(self.hw, self.device)
        e = lambda i, j: _col(hinv[:, i, j])
        den = e(2, 0) * xs + e(2, 1) * ys + e(2, 2)
        sx = (e(0, 0) * xs + e(0, 1) * ys + e(0, 2)) / den
        sy = (e(1, 0) * xs + e(1, 1) * ys + e(1, 2)) / den
        board_val, inb = _bilinear_sample(self.board, sx, sy)
        on_board = (inb & (sx >= self.board_x0) & (sx <= self.board_x1 - 1)
                    & (sy >= self.board_y0) & (sy <= self.board_y1 - 1))

        bg = _procedural_bg(d["bg"], self.hw)
        if "bank" in d:
            bg = torch.where(_col(d["bank"]["use"]), _bank_bg(d["bank"], self.bg_bank,
                                                              self.hw), bg)
        hole = _dropout_mask(d["hole"], self.hw)
        negative = d["negative"]
        paste = on_board & ~hole & ~_col(negative)
        img = _photometric(d["photo"], torch.where(paste, board_val, bg))

        # corners forward through the same homography as the pixels
        c = self.corners
        wk = (c[:, 0] * pv[:, 0, None] + c[:, 1] * pv[:, 1, None]) + d0[:, None]
        kx = (c[:, 0] * A[:, 0, 0, None] + c[:, 1] * A[:, 0, 1, None] + t[:, 0, None]) / wk
        ky = (c[:, 0] * A[:, 1, 0, None] + c[:, 1] * A[:, 1, 1, None] + t[:, 1, None]) / wk
        kxi = kx.to(torch.int32).clamp(0, w - 1).long()
        kyi = ky.to(torch.int32).clamp(0, h - 1).long()
        in_frame = (kx >= 0) & (kx < w) & (ky >= 0) & (ky < h)
        in_hole = torch.gather(hole.reshape(hole.shape[0], -1), 1, kyi * w + kxi)
        visible = in_frame & ~in_hole & ~negative[:, None]
        loc, ids = _label_maps(kx, ky, visible, d["perm"], self.hw, self.n_ids)
        img_norm = ((img - 128.0) / 255.0)[..., None]
        return img_norm, loc, ids, torch.stack([kx, ky], -1), visible

    def render(self, d: Draws):
        """(images (B, H, W, 1) float32, loc (B, Hc, Wc) int32, ids int32)."""
        return self.render_full(d)[:3]

    def batch(self, gen: torch.Generator, n: int, share=None):
        """``n`` fresh samples: :meth:`render` of :meth:`draw`; with
        ``share=(i, k)`` only share ``i`` of ``k`` of them."""
        return self.render(slice_draws(self.draw(gen, n), *share_rows(n, share)))


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (B, 3, 3) matrices by the adjugate (no solver launch)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    g, h, i = m[:, 2, 0], m[:, 2, 1], m[:, 2, 2]
    co = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                      f * g - d * i, a * i - c * g, c * d - a * f,
                      d * h - e * g, b * g - a * h, a * e - b * d], -1).reshape(-1, 3, 3)
    det = a * co[:, 0, 0] + b * co[:, 1, 0] + c * co[:, 2, 0]
    return co / det[:, None, None]


class FramePatchSynthesizer:
    """RefineNet patches cut from full synthesized frames by the inference
    pipeline's own gather (``ops.patches.extract_patches``): per frame,
    ``per_frame`` corners (visible, ≥ 4 px inside, distinct where it can),
    each patch centered at ``round(corner + jitter)`` (jitter ≤
    ±``jitter_px``), each label a Gaussian at ``(corner − center)·8 + 32``
    on the 64×64 grid."""

    def __init__(self, config: Config, jitter_px: float = 3.0, per_frame: int = 8,
                 continuous_targets: bool = True, patch_size: int = 24,
                 perspective_p: float = 0.0, device=None):
        self.inner = DeviceSynthesizer(config, negative_p=0.0, perspective_p=perspective_p,
                                       device=device)
        self.device = self.inner.device
        self.hw = config.input_hw
        self.n_ids = config.n_ids
        self.jitter = jitter_px
        self.per_frame = per_frame
        self.patch_size = patch_size
        self.continuous = continuous_targets

    def frames(self, batch_size: int) -> int:
        return max(1, batch_size // self.per_frame)

    def draw(self, gen: torch.Generator, batch_size: int) -> Draws:
        f, dev = self.frames(batch_size), self.device
        return {"frame": self.inner.draw(gen, f),
                "pick": torch.rand((f, self.per_frame, self.n_ids), generator=gen, device=dev),
                "jitter": _uniform(gen, (f, self.per_frame, 2), -self.jitter, self.jitter, dev)}

    def render(self, d: Draws, batch_size: Optional[int] = None):
        """(patches (B, P, P, 1), heatmaps (B, 64, 64, 1)) float32, ``B`` =
        ``batch_size`` (all of them when None)."""
        from deepcharuco_tpu_torch.ops.patches import extract_patches

        h, w = self.hw
        img, _, _, kpts, visible = self.inner.render_full(d["frame"])
        in_frame = (visible & (kpts[..., 0] >= 4) & (kpts[..., 0] < w - 4)
                    & (kpts[..., 1] >= 4) & (kpts[..., 1] < h - 4))
        scores = in_frame[:, None, :].float() * 10.0 + d["pick"]
        idx = torch.argmax(scores, dim=-1)                          # (F, P)
        p = torch.gather(kpts, 1, idx[..., None].expand(-1, -1, 2))  # (F, P, 2)
        center = torch.round(p + d["jitter"])
        patches = extract_patches(img[..., 0], center, patch_size=self.patch_size)
        heat = _heatmaps((p - center) * 8.0 + 32.0, self.continuous)
        ps = self.patch_size
        n = batch_size or patches.shape[0] * patches.shape[1]
        return (patches.reshape(-1, ps, ps, 1)[:n], heat.reshape(-1, 64, 64, 1)[:n])

    def batch(self, gen: torch.Generator, batch_size: int, share=None):
        """``batch_size`` patches from ``batch_size // per_frame`` frames;
        with ``share=(i, k)`` only share ``i`` of ``k`` of them, rendered
        from that share's frames when it is a whole number of frames (else
        every frame is rendered, with a warning)."""
        d = self.draw(gen, batch_size)
        lo, hi = share_rows(batch_size, share)
        if hi - lo == batch_size:
            return self.render(d, batch_size)
        if lo % self.per_frame == 0 and hi % self.per_frame == 0:
            return self.render(slice_draws(d, lo // self.per_frame, hi // self.per_frame),
                               hi - lo)
        warnings.warn(f"FramePatchSynthesizer: a share of {hi - lo} patches is not a "
                      f"multiple of per_frame ({self.per_frame}); every share renders all "
                      "the frames", stacklevel=2)
        return tuple(t[lo:hi] for t in self.render(d, batch_size))


class DeviceRefineSynthesizer:
    """RefineNet patches rendered directly: the board warped at 2× the
    config's resolution, one corner per patch, the patch sampled at stride 2
    on the integer grid inference crops, and a Gaussian target at the
    corner's exact sub-pixel position (``continuous_targets=False`` rounds
    it to the 1/8-px grid, as the reference does)."""

    def __init__(self, config: Config, continuous_targets: bool = True,
                 patch_size: int = 24, device=None):
        big = dataclasses.replace(config, input_size=(config.input_size[0] * 2,
                                                      config.input_size[1] * 2))
        self.inner = DeviceSynthesizer(big, negative_p=0.0, refinenet_ranges=True,
                                       device=device)
        self.device = self.inner.device
        self.hw = big.input_hw
        self.n_ids = config.n_ids
        self.continuous = continuous_targets
        self.patch_size = patch_size

    def draw(self, gen: torch.Generator, n: int) -> Draws:
        dev, ps = self.device, (self.patch_size, self.patch_size)
        return {"affine": draw_affine(gen, n, self.inner.scale_range,
                                      self.inner.translate_frac, 0.0, dev),
                "idx": torch.randint(0, self.n_ids, (n,), generator=gen, device=dev),
                "off": _uniform(gen, (n, 2), -3.99, 3.99, dev),
                "bg": draw_procedural_bg(gen, n, ps, dev),
                "photo": draw_photometric(gen, n, ps, 0.0, None, dev)}

    def render(self, d: Draws):
        """(patches (B, P, P, 1) normalized, heatmaps (B, 64, 64, 1))."""
        A, t = _affine_params(d["affine"], self.hw)
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
        c = self.inner.corners[d["idx"]]                             # (B, 2)
        p = torch.stack([c[:, 0] * A[:, 0, 0] + c[:, 1] * A[:, 0, 1],
                         c[:, 0] * A[:, 1, 0] + c[:, 1] * A[:, 1, 1]], -1) + t
        center = torch.round(p / 2.0 + d["off"])
        half = self.patch_size // 2
        r = torch.arange(-half, half, dtype=torch.float32, device=self.device)
        sy_d = 2.0 * (center[:, 1, None, None] + r[None, :, None])  # (B, P, 1)
        sx_d = 2.0 * (center[:, 0, None, None] + r[None, None, :])  # (B, 1, P)
        i00, i01 = _col(A[:, 1, 1] / det), _col(-A[:, 0, 1] / det)
        i10, i11 = _col(-A[:, 1, 0] / det), _col(A[:, 0, 0] / det)
        sx = i00 * (sx_d - _col(t[:, 0])) + i01 * (sy_d - _col(t[:, 1]))
        sy = i10 * (sx_d - _col(t[:, 0])) + i11 * (sy_d - _col(t[:, 1]))
        val, inb = _bilinear_sample(self.inner.board, sx, sy)
        inner = self.inner
        bg = _procedural_bg(d["bg"], (self.patch_size, self.patch_size))
        on_board = (inb & (sx >= inner.board_x0) & (sx <= inner.board_x1 - 1)
                    & (sy >= inner.board_y0) & (sy <= inner.board_y1 - 1))
        patch = _photometric(d["photo"], torch.where(on_board, val, bg))
        heat = _heatmaps((p / 2.0 - center) * 8.0 + 32.0, self.continuous)
        return ((patch - 128.0) / 255.0)[..., None], heat[..., None]

    def batch(self, gen: torch.Generator, n: int, share=None):
        """``n`` fresh patches; with ``share=(i, k)`` only share ``i`` of
        ``k`` of them."""
        return self.render(slice_draws(self.draw(gen, n), *share_rows(n, share)))


def load_draws(arrays, prefix: str, device=None) -> Draws:
    """Draws stored flat under '/'-joined keys (``<prefix>/affine/s``, …; the
    layout ``scripts/make_torch_port_fixture.py`` writes) → the nested dict
    :meth:`render` takes, on ``device``; float16 fields come back as
    float32."""
    dev = resolve_device(device)
    out: Draws = {}
    for key in arrays:
        if not key.startswith(prefix + "/"):
            continue
        value = torch.as_tensor(arrays[key])
        if value.dtype == torch.float16:
            value = value.float()
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.to(dev)
    return out


def make_background_bank(n: int = 64, size_hw: Tuple[int, int] = (480, 640), seed: int = 0,
                         labels=None, images_folder=None, use_native: bool = True):
    """(n, H, W) float32 gray backgrounds for :class:`DeviceSynthesizer`'s
    ``bg_bank``, built on the host once at set-up from the configured photo
    source (COCO json, directory, else procedural: the order of
    :func:`~deepcharuco_tpu_torch.data.sources.open_image_source`). Image
    ``i`` is source image ``rng.integers(0, len(source))`` of a generator
    seeded ``seed``, gray (cv2's fixed point) and, where its size differs,
    shrunk or grown by INTER_AREA. This is how a real photo corpus reaches
    the on-card synthesis: the bank crosses to the card once."""
    import numpy as np

    from deepcharuco_tpu_torch.data import cvnp
    from deepcharuco_tpu_torch.data.sources import open_image_source

    src = open_image_source(labels, images_folder, size_hw=size_hw, use_native=use_native)
    rng = np.random.default_rng(seed)
    out = np.zeros((n, *size_hw), np.float32)
    for i in range(n):
        gray = cvnp.bgr2gray(src.get(int(rng.integers(0, len(src)))))
        if gray.shape != tuple(size_hw):
            gray = cvnp.resize_area(gray, size_hw)
        out[i] = gray.astype(np.float32)
    return out
