"""The inference pipeline's reference, and the readings that judge a
program's answers by it.

Every answer gets a gap: how far it lies below what the reference holds
best, so a near-tie that rounding flips costs only the size of the tie.

- decode (logits), per slot: where the program fills it, how far its
  cell's loc logit at the program's pixel lies below the cell's best loc
  logit (the dustbin included), its id below the cell's best id (the
  dustbin included), and its confidence below the best confidence of a
  cell that the reference gives that id; where it leaves it empty, the
  margin by which a reference cell claims that id.
- refinement, per filled slot: with the hard decode, the reference
  heatmap (on the patch the program's corner centres) at the program's
  sub-pixel choice below its maximum; with the soft decode, the distance
  in pixels between the program's corner and the reference's soft-argmax.
- pose (px), per frame whose pose its corners determine: at least
  ``MIN_CORNERS`` of them, a reference optimum (float64) that fits them
  within ``FIT_PX``, no second pose that fits them as well (the
  reference's other start, the planar twin, ends more than ``APART_RAD``
  away within ``FIT_PX``), and an optimum that the reference's
  Levenberg–Marquardt reaches (within ``SETTLED_PX``) in half of the
  configured iterations. The gap is the reprojection RMS of the program's
  pose on its own corners above that optimum, or its reported RMS away
  from that RMS, whichever is larger; infinite where the program does not
  call the frame solved. On the other frames the configured solver's
  answer need not be the optimum: four coplanar corners, or four in a row
  and one beside them, leave its iterations short of it even in float64,
  corners with a wrong id fit no pose and leave many local minima, and two
  poses that both fit are both answers. They are counted
  (``pose_frames_left``) and not judged.

The readings are a high percentile of those gaps (``*_p99``, ``*_p90``)
and the widest (``*_max``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import nets, pose

MIN_CORNERS = 5
FIT_PX = 1.0
APART_RAD = 1e-3
SETTLED_PX = 1e-4


def gray(frames_u8: torch.Tensor, scale: int) -> torch.Tensor:
    """uint8 (N, H, W) → (full-resolution normalized gray (N, 1, H, W),
    the detector's view: 2x2 averages ``log2(scale)`` times)."""
    g = (frames_u8.float() - 128.0) / 255.0
    g = g[:, None]
    lo = g
    while lo.shape[-1] * scale > g.shape[-1]:
        lo = F.avg_pool2d(lo, 2)
    return g, lo


def patches(g: torch.Tensor, centers: torch.Tensor, size: int) -> torch.Tensor:
    """(N, 1, H, W) gray, integer centres (N, K, 2) (x, y), clipped into the
    frame → (N·K, 1, P, P), zero outside the frame."""
    n, _, h, w = g.shape
    k = centers.shape[1]
    cx = centers[..., 0].long().clamp(0, w - 1)
    cy = centers[..., 1].long().clamp(0, h - 1)
    half = size // 2
    pad = F.pad(g[:, 0], (half, half, half, half))
    off = torch.arange(size, device=g.device)
    rows = (cy[..., None] + off)[..., :, None]              # padded coordinates
    cols = (cx[..., None] + off)[..., None, :]
    b = torch.arange(n, device=g.device)[:, None, None, None]
    return pad[b, rows, cols].reshape(n * k, 1, size, size)


def soft_xy(heat: torch.Tensor, temperature: float) -> torch.Tensor:
    """Softmax-expectation (x, y) of (M, 64, 64) heatmaps."""
    m, h, w = heat.shape
    p = torch.softmax(heat.reshape(m, h * w) * temperature, -1).reshape(m, h, w)
    xs = torch.arange(w, dtype=heat.dtype, device=heat.device)
    ys = torch.arange(h, dtype=heat.dtype, device=heat.device)
    return torch.stack([(p.sum(1) * xs).sum(-1), (p.sum(2) * ys).sum(-1)], -1)


class Reference:
    """The configuration's networks on ``device`` from its weight files."""

    def __init__(self, cfg: dict, root, device):
        self.cfg = cfg
        self.device = device
        self.det = nets.read_weights(str(root / cfg["detector"]["weights"]), device)
        self.rn = nets.read_weights(str(root / cfg["refinenet"]["weights"]), device)
        self.scale = cfg.get("hires_scale", 1)
        self.n_ids = cfg["n_ids"]
        cam = cfg["camera"]
        K = np.array(cam["K"], np.float64)
        if self.scale > 1:          # corners come in the detector's (pooled) units
            K[:2, :2] /= self.scale
            K[:2, 2] = (K[:2, 2] + 0.5) / self.scale - 0.5
        self.K, self.dist = K, np.array(cam["dist"], np.float64)

    # ----- the reference put in the program's place (the control) --------
    def run(self, frames_u8: np.ndarray, q=nets.identity, pose_dtype=torch.float64,
            block: int = 64) -> Dict[str, np.ndarray]:
        """The whole pipeline on ``frames_u8``, networks quantized by ``q``
        and the pose solved in ``pose_dtype``: the outputs the program
        hands out, as numpy."""
        outs = []
        for i in range(0, len(frames_u8), block):
            x = torch.from_numpy(frames_u8[i:i + block]).to(self.device)
            g, lo = gray(x, self.scale)
            loc, ids = nets.detector(self.det, lo, q)
            kp, valid = self._decode(loc, ids)
            refined = self._refine(g, kp, q)
            outs.append((kp, valid, refined))
        kp, valid, refined = (torch.cat(t).cpu().numpy() for t in zip(*outs))
        ok, rvec, tvec, rms = pose.solve(self.cfg["board"], self.K, self.dist,
                                         torch.from_numpy(refined).to(self.device),
                                         torch.from_numpy(valid).to(self.device),
                                         dtype=pose_dtype, iters=self.cfg["pnp_iters"])
        return {"keypoints": kp, "valid": valid, "refined": refined, "ok": ok,
                "rvec": rvec, "tvec": tvec, "reproj_rms": rms}

    def _decode(self, loc, ids):
        """Argmax decode: a cell claims the id of its best ids logit unless
        either head's best is its dustbin; the claiming cell with the
        highest confidence wins, ties to the lowest cell."""
        n, _, hc, wc = loc.shape
        lf = loc.flatten(2).transpose(1, 2)
        idf = ids.flatten(2).transpose(1, 2)
        pix = lf.argmax(-1)
        conf, best = idf.max(-1)
        claim = (pix != 64) & (best != self.n_ids)
        kp = torch.zeros(n, self.n_ids, 2, device=loc.device)
        valid = torch.zeros(n, self.n_ids, dtype=torch.bool, device=loc.device)
        cells = torch.arange(hc * wc, device=loc.device)
        for k in range(self.n_ids):
            score = torch.where(claim & (best == k), conf, torch.tensor(-torch.inf,
                                                                        device=loc.device))
            top = score.max(-1, keepdim=True).values
            first = torch.where(score == top, cells, hc * wc).min(-1).values
            valid[:, k] = torch.isfinite(top[:, 0])
            p = pix.gather(1, first.clamp(max=hc * wc - 1)[:, None])[:, 0]
            c = first.clamp(max=hc * wc - 1)
            kp[:, k, 0] = 8 * (c % wc) + p % 8
            kp[:, k, 1] = 8 * (c // wc) + p // 8
        return kp * valid[..., None], valid

    def _heat(self, g, kp, q):
        """RefineNet heatmaps (N, K, 64, 64) on the patches centred on the
        corners (in the full-resolution frame)."""
        r = self.cfg["refinenet"]
        centers = kp * self.scale
        heat = nets.refinenet(self.rn, patches(g, centers, r["patch_size"]),
                              r["patch_size"], q)
        return heat.reshape(kp.shape[0], kp.shape[1], 64, 64)

    def _refine(self, g, kp, q):
        r = self.cfg["refinenet"]
        heat = self._heat(g, kp, q)
        n, k = kp.shape[:2]
        if r["decode"] == "soft":
            xy = soft_xy(heat.reshape(n * k, 64, 64), r["soft_temperature"]).reshape(n, k, 2)
        else:
            flat = heat.reshape(n, k, -1).argmax(-1)
            xy = torch.stack([flat % 64, flat // 64], -1).float()
        s = self.scale
        return ((kp * s + (xy - 32.0) / 8.0) - (s - 1) * 0.5) / s

    # ----- the readings ---------------------------------------------------
    @torch.no_grad()
    def judge(self, frames_u8: np.ndarray, out: Dict[str, np.ndarray],
              block: int = 64) -> Dict[str, float]:
        """The readings of the answers ``out`` (the program's keys, one row
        per frame of ``frames_u8``)."""
        dec, ref = [], []
        for i in range(0, len(frames_u8), block):
            sl = slice(i, i + block)
            x = torch.from_numpy(frames_u8[sl]).to(self.device)
            kp = torch.from_numpy(np.ascontiguousarray(out["keypoints"][sl])).float().to(self.device)
            valid = torch.from_numpy(np.ascontiguousarray(out["valid"][sl])).bool().to(self.device)
            refined = torch.from_numpy(np.ascontiguousarray(out["refined"][sl])).float().to(self.device)
            g, lo = gray(x, self.scale)
            loc, ids = nets.detector(self.det, lo, nets.identity)
            dec.append(self._decode_gap(loc, ids, kp, valid))
            ref.append(self._refine_gap(g, kp, valid, refined))
        self.slot_gaps = {"decode": torch.cat(dec).cpu().numpy(),
                          "refine": torch.cat(ref).cpu().numpy()}
        self.frame_gaps, left = self._pose_gaps(out)
        refine = "refine_px_gap" if self.cfg["refinenet"]["decode"] == "soft" else \
            "refine_heat_gap"
        r = self.slot_gaps["refine"][out["valid"].astype(bool)]
        pose_gaps = self.frame_gaps if self.frame_gaps.size else np.zeros(1)
        return {"decode_gap_p99": float(np.quantile(self.slot_gaps["decode"], 0.99, method="higher")),
                "decode_gap_max": float(self.slot_gaps["decode"].max()),
                f"{refine}_p99": float(np.quantile(r, 0.99, method="higher")) if r.size else 0.0,
                f"{refine}_max": float(r.max()) if r.size else 0.0,
                "pose_gap_p90": float(np.quantile(pose_gaps, 0.90, method="higher")),
                "pose_gap_max": float(pose_gaps.max()),
                "pose_frames": int(self.frame_gaps.size), "pose_frames_left": left}

    def _decode_gap(self, loc, ids, kp, valid) -> torch.Tensor:
        """(N, n_ids) gaps of every slot."""
        n, _, hc, wc = loc.shape
        lf = loc.flatten(2).transpose(1, 2)                      # (N, M, 65)
        idf = ids.flatten(2).transpose(1, 2)                     # (N, M, n_ids+1)
        x, y = kp[..., 0].long(), kp[..., 1].long()
        inside = (x >= 0) & (x < 8 * wc) & (y >= 0) & (y < 8 * hc)
        cell = ((y // 8).clamp(0, hc - 1) * wc + (x // 8).clamp(0, wc - 1))   # (N, K)
        pix = (y % 8) * 8 + x % 8
        lcell = lf.gather(1, cell[..., None].expand(-1, -1, lf.shape[-1]))     # (N, K, 65)
        icell = idf.gather(1, cell[..., None].expand(-1, -1, idf.shape[-1]))
        k = torch.arange(self.n_ids, device=loc.device).expand(n, -1)
        gap_pix = lcell.amax(-1) - lcell.gather(-1, pix[..., None])[..., 0]
        mine = icell.gather(-1, k[..., None])[..., 0]
        gap_id = icell.amax(-1) - mine
        # the reference's claims: per cell, its id and the margin of its claim
        loc_margin = lf[..., :64].amax(-1) - lf[..., 64]
        top2 = idf.topk(2, -1)
        best = top2.indices[..., 0]
        id_margin = top2.values[..., 0] - top2.values[..., 1]
        claims = (loc_margin > 0) & (best != self.n_ids)
        conf = top2.values[..., 0]
        claim_of = torch.where(claims[:, None, :] & (best[:, None, :] == k[..., None]),
                               conf[:, None, :], torch.tensor(-torch.inf, device=loc.device))
        gap_win = (claim_of.amax(-1) - mine).clamp_min(0)
        strength = torch.where(claims[:, None, :] & (best[:, None, :] == k[..., None]),
                               torch.minimum(loc_margin, id_margin)[:, None, :],
                               torch.tensor(0.0, device=loc.device)).amax(-1)
        filled = torch.maximum(torch.maximum(gap_pix, gap_id), gap_win)
        filled = torch.where(inside, filled, torch.tensor(torch.inf, device=loc.device))
        return torch.where(valid, filled, strength)

    def _refine_gap(self, g, kp, valid, refined) -> torch.Tensor:
        """(N, n_ids) gaps of every slot, 0 where the program fills none."""
        heat = self._heat(g, kp, nets.identity)
        n, k = kp.shape[:2]
        s = self.scale
        if self.cfg["refinenet"]["decode"] == "soft":
            xy = soft_xy(heat.reshape(n * k, 64, 64),
                         self.cfg["refinenet"]["soft_temperature"]).reshape(n, k, 2)
            want = ((kp * s + (xy - 32.0) / 8.0) - (s - 1) * 0.5) / s
            gap = torch.linalg.vector_norm(refined - want, dim=-1)
        else:
            a = torch.round((refined * s + (s - 1) * 0.5 - kp * s) * 8.0 + 32.0).long()
            inside = ((a >= 0) & (a < 64)).all(-1)
            flat = heat.reshape(n, k, -1)
            at = flat.gather(-1, (a[..., 1].clamp(0, 63) * 64 + a[..., 0].clamp(0, 63))[..., None])
            gap = torch.where(inside, flat.amax(-1) - at[..., 0],
                              torch.tensor(torch.inf, device=kp.device))
        return torch.where(valid, gap, torch.zeros((), device=kp.device))

    def _pose_gaps(self, out):
        """(gaps of the frames whose pose the corners determine, px; the
        number of the other frames that either side solves)."""
        board = self.cfg["board"]
        refined, valid = out["refined"].astype(np.float64), out["valid"].astype(bool)
        ok_ref, _, _, rms_ref, rms_twin, apart = pose.solve(
            board, self.K, self.dist, torch.from_numpy(refined), torch.from_numpy(valid),
            iters=50, twin_out=True)
        _, _, _, rms_half = pose.solve(board, self.K, self.dist, torch.from_numpy(refined),
                                       torch.from_numpy(valid), iters=self.cfg["pnp_iters"] // 2)
        ok = out["ok"].astype(bool)
        det = ok_ref & (valid.sum(-1) >= MIN_CORNERS) & (rms_ref <= FIT_PX) \
            & ~((rms_twin <= FIT_PX) & (apart > APART_RAD)) & (rms_half - rms_ref <= SETTLED_PX)
        gap = np.where(ok, 0.0, np.inf)
        both = det & ok
        if both.any():
            at = pose.rms_at(board, self.K, self.dist, refined[both], valid[both],
                             out["rvec"][both], out["tvec"][both])
            g = np.maximum(at - rms_ref[both], np.abs(out["reproj_rms"][both] - at))
            gap[both] = np.where(np.isfinite(g), g, np.inf)
        return gap[det], int(((ok | ok_ref) & ~det).sum())
