"""SuperPoint + LightGlue as the benchmark runs it: the port's
``matching.MatchPipeline`` built from a configuration with weights drawn
from the seed, its plain reference's judge (``reference/
superpoint_lightglue.py``), the control, the planted faults and the
analytic FLOPs. The interface is ``programs/__init__.py``'s (serving).

Each answer is judged by its gap below the reference's best, on whole
pairs drawn from those handed out:

- ``select_gap_p90``: per chosen keypoint, the reference's k-th NMS score
  minus its NMS score at that pixel, floored at 0, over the k-th score;
  the 90th percentile (bf16 near-ties flip a few percent of NMS maxima to
  a neighbour, which reads 1 there);
- ``score_gap_max``: the keypoint's score against the reference's score at
  its pixel, relative;
- ``count_gap``: keypoints the reference keeps that the program does not
  (or the other way round), the largest over frames;
- the reference then runs LightGlue on the program's keypoints with its own
  float32 descriptors sampled there. ``assign_gap_p99``: for every match
  the program hands out, the reference's row (image 0) or column (image 1)
  maximum of the log assignment minus its value at the program's partner,
  99th percentile (bf16 moves near-ties); ``decision_flip_share``: the
  share of points whose decision the reference makes clear of the
  threshold by ``MARGIN`` (log units) and the program makes the other way
  (a clear match: the mutual best, both runners-up ``MARGIN`` below, and
  exp(score) above threshold·e^MARGIN; a clear non-match: exp(row maximum)
  under threshold·e^−MARGIN); ``clear_match_miss_share``: of the points the
  reference matches clearly, the share the program leaves unmatched or
  matches elsewhere (few points are matched, so a program that matches
  too few moves ``decision_flip_share`` little); ``match_score_gap_p99``:
  the program's match score against exp of the reference's log assignment
  at the same pair of points, 99th percentile. Where the program hands out
  no match and the reference matches some point, both 99th percentiles
  read inf.

``matched_share`` and ``ref_matched_share`` (the program's and the
reference's share of valid keypoints matched) are reported, not compared.

The control runs the reference in the program's place with the operands of
every convolution, every linear layer and both products of attention
rounded to float8 e4m3 (per-tensor scale; the format of
``torch._scaled_mm``, torch's lowest-precision matrix product; torch has no
lower attention than bf16, so attention's products take the same
rounding), the scores, NMS and assignment in float32 as configured.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench import harness
from portbench.counts import conv_flops
from portbench.reference import superpoint_lightglue as ref

OUTPUTS = ("keypoints", "keypoint_scores", "matches", "match_scores")
MARGIN = 0.5            # log units: a decision this far from its alternatives is clear


def _conf(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("descriptor_dim", "n_layers", "num_heads", "nms_radius",
                                "detection_threshold", "remove_borders",
                                "max_num_keypoints", "filter_threshold", "weight_draw")}


# ----- the system under test --------------------------------------------------
def build(cfg: dict, root, seed: int, device):
    """``MatchPipeline`` with weights drawn from ``seed`` (the reference's
    ``draw_weights``) at the configuration's widths and precision."""
    from deepcharuco_tpu_torch.matching import MatchPipeline

    sp, lg = ref.draw_weights(_conf(cfg), seed)
    return MatchPipeline(sp, lg, max_num_keypoints=cfg["max_num_keypoints"],
                         nms_radius=cfg["nms_radius"],
                         detection_threshold=cfg["detection_threshold"],
                         remove_borders=cfg["remove_borders"],
                         descriptor_dim=cfg["descriptor_dim"], n_layers=cfg["n_layers"],
                         num_heads=cfg["num_heads"], filter_threshold=cfg["filter_threshold"],
                         compute_dtype=getattr(torch, cfg["compute_dtype"]), device=device)


def instrument(spans, pipe, layers: bool) -> None:
    """A traced run's span around ``forward_device``; the layers' spans are
    the program's own (``match.*``)."""
    spans.wrap(pipe, "forward_device", "forward_device")


# ----- the reference ------------------------------------------------------------
def _valid_rows(out: Dict[str, np.ndarray], i: int):
    """Frame ``i``'s valid slots (bool), keypoints there (float32 (m, 2))."""
    valid = out["keypoint_scores"][i] > 0
    return valid, torch.from_numpy(np.ascontiguousarray(out["keypoints"][i][valid]))


def judge(cfg: dict, root, seed: int, device, frames_u8: np.ndarray,
          out: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The readings of the answers ``out`` (one row a frame, pairs in rows
    2i, 2i+1) on ``frames_u8`` against the reference on the same weights."""
    conf = _conf(cfg)
    sp, lg = ref.draw_weights(conf, seed)
    sp = {k: v.to(device) for k, v in sp.items()}
    lg = {k: v.to(device) for k, v in lg.items()}
    h, w = cfg["input_hw"]
    sel: List[np.ndarray] = []
    score_gap = count_gap = 0.0
    dense_desc = []
    for lo in range(0, len(frames_u8), 16):
        img = torch.from_numpy(frames_u8[lo:lo + 16]).to(device).float()[:, None] / 255.0
        ex = ref.extract(sp, img, conf)
        for j in range(len(img)):
            i = lo + j
            valid, kp = _valid_rows(out, i)
            # a keypoint off the image's pixel grid reads the largest gaps
            on_grid = ((kp == kp.round()).all(1) & (kp[:, 0] >= 0) & (kp[:, 0] < w)
                       & (kp[:, 1] >= 0) & (kp[:, 1] < h)).to(device)
            xy = torch.where(on_grid[:, None], kp.to(device), 0.0).long()
            nms, dense = ex["nms_scores"][j], ex["dense_scores"][j]
            kth = ex["keypoint_scores"][j].min()
            gap = ((kth - nms[xy[:, 1], xy[:, 0]]).clamp_min(0) / kth)
            sel.append(torch.where(on_grid, gap, 1.0).cpu().numpy())
            raw = dense[xy[:, 1], xy[:, 0]]
            got = torch.from_numpy(out["keypoint_scores"][i][valid]).to(device)
            if len(raw):
                rel = torch.where(on_grid, (got - raw).abs() / raw, math.inf)
                score_gap = max(score_gap, float(rel.max()))
            count_gap = max(count_gap, abs(len(ex["keypoints"][j]) - int(valid.sum())))
        dense_desc.append(ex["dense_descriptors"])
    dense_desc = torch.cat(dense_desc)
    assign, score_gaps = [], []
    flips = clear = missed = matched = ref_matched = points = 0
    for p in range(len(frames_u8) // 2):
        a, b = 2 * p, 2 * p + 1
        (va, ka), (vb, kb) = _valid_rows(out, a), _valid_rows(out, b)
        if not len(ka) or not len(kb):
            continue
        ka_f, kb_f = ka.to(device), kb.to(device)
        da = ref.sample_descriptors(ka_f[None], dense_desc[a:a + 1])[0].t()
        db = ref.sample_descriptors(kb_f[None], dense_desc[b:b + 1])[0].t()
        r = ref.match(lg, ka_f, kb_f, da, db, (w, h), conf)
        S = r["scores"][:-1, :-1]
        for i, s, valid, other, ref_m in ((a, S, va, vb, r["matches0"]),
                                          (b, S.t(), vb, va, r["matches1"])):
            m = torch.from_numpy(_slot_index(valid, other, out["matches"][i])).to(device)
            ms = torch.from_numpy(out["match_scores"][i][valid]).to(device)
            hit = m >= 0
            at = s.gather(1, m.clamp_min(0)[:, None])[:, 0]
            if hit.any():
                assign.append((s.max(1).values - at)[hit].cpu().numpy())
                score_gaps.append((ms - at.exp())[hit].abs().cpu().numpy())
            wrong, n_clear, n_missed = _decisions(s, m, cfg["filter_threshold"])
            flips, clear, missed = flips + wrong, clear + n_clear, missed + n_missed
            matched += int(hit.sum())
            ref_matched += int((ref_m >= 0).sum())
            points += len(m)
    # no match handed out reads inf where the reference matched: nothing
    # the program answered can stand in for what it left out
    empty = math.inf if ref_matched else 0.0
    p99 = lambda xs: float(np.quantile(np.concatenate(xs), 0.99)) if xs else empty
    sel_all = np.concatenate(sel + [np.zeros(0)])
    points = max(points, 1)
    return {"select_gap_p90": float(np.quantile(sel_all, 0.9)) if sel_all.size else 0.0,
            "score_gap_max": score_gap,
            "count_gap": float(count_gap),
            "assign_gap_p99": p99(assign),
            "decision_flip_share": flips / points,
            "clear_match_miss_share": missed / max(clear, 1),
            "match_score_gap_p99": p99(score_gaps),
            "matched_share": matched / points,
            "ref_matched_share": ref_matched / points}


def _slot_index(valid: np.ndarray, other: np.ndarray, matches: np.ndarray) -> np.ndarray:
    """A frame's matches over its valid slots, as indices among the
    partner's valid keypoints (−1 where unmatched or pointing at an invalid
    slot)."""
    pos = np.cumsum(other) - 1
    m = matches[valid].astype(np.int64)
    ok = (m >= 0) & (m < len(other))
    ok[ok] &= other[m[ok]]
    return np.where(ok, pos[np.clip(m, 0, len(other) - 1)], -1)


def _decisions(s: torch.Tensor, m: torch.Tensor, threshold: float):
    """(points whose match decision the reference's log assignment ``s``
    (rows: this frame's points) makes clear by ``MARGIN`` and the program's
    matches ``m`` make otherwise, the reference's clear matches, those of
    them the program does not make)."""
    top = s.topk(min(2, s.shape[1]), 1)
    best, j = top.values[:, 0], top.indices[:, 0]
    second = top.values[:, 1] if s.shape[1] > 1 else torch.full_like(best, -math.inf)
    col = s.topk(min(2, s.shape[0]), 0).values
    col_second = col[1] if s.shape[0] > 1 else torch.full_like(col[0], -math.inf)
    # the best of the partner point's column other than this row
    other_in_col = torch.where(col[0][j] == best, col_second[j], col[0][j])
    log_th = math.log(threshold)
    clear_match = ((best > log_th + MARGIN) & (second < best - MARGIN)
                   & (other_in_col < best - MARGIN))
    clear_none = best < log_th - MARGIN
    missed = clear_match & (m != j)
    wrong = missed | (clear_none & (m >= 0))
    return int(wrong.sum()), int(clear_match.sum()), int(missed.sum())


# ----- the control ----------------------------------------------------------------
def control(c: dict, seed: int, device) -> Dict[str, float]:
    """The control's readings on the pairs a run of ``seed`` judges (the
    cell's driver's ``control_inputs``): the reference with float8 e4m3
    products in the program's place."""
    from portbench.common import full_float32
    from portbench.reference import nets

    inputs = harness.driver(c).control_inputs(c, seed, device)
    cfg, frames_u8 = inputs["cfg"], inputs["frames"]
    conf = _conf(cfg)
    k = cfg["max_num_keypoints"]
    h, w = cfg["input_hw"]
    sp, lg = ref.draw_weights(conf, seed)
    sp = {key: v.to(device) for key, v in sp.items()}
    lg = {key: v.to(device) for key, v in lg.items()}
    n = len(frames_u8)
    out = {"keypoints": np.zeros((n, k, 2), np.float32),
           "keypoint_scores": np.zeros((n, k), np.float32),
           "matches": np.full((n, k), -1, np.int32), "match_scores": np.zeros((n, k), np.float32)}
    with full_float32():
        img = torch.from_numpy(frames_u8).to(device).float()[:, None] / 255.0
        ex = ref.extract(sp, img, conf, q=nets.fp8)
        for p in range(n // 2):
            a, b = 2 * p, 2 * p + 1
            r = ref.match(lg, ex["keypoints"][a], ex["keypoints"][b], ex["descriptors"][a],
                          ex["descriptors"][b], (w, h), conf, q=nets.fp8)
            for i, m, ms in ((a, r["matches0"], r["matching_scores0"]),
                             (b, r["matches1"], r["matching_scores1"])):
                kn = len(ex["keypoints"][i])
                out["keypoints"][i, :kn] = ex["keypoints"][i].cpu().numpy()
                out["keypoint_scores"][i, :kn] = ex["keypoint_scores"][i].cpu().numpy()
                out["matches"][i, :kn] = m.cpu().numpy()
                out["match_scores"][i, :kn] = ms.cpu().numpy()
        return judge(cfg, harness.ROOT, seed, device, frames_u8, out)


# ----- faults planted in the timed path ---------------------------------------
def _forward(run, change):
    fn = run.pipe.forward_device

    def faulty(frames):
        return change(list(fn(frames)), frames)

    run.pipe.forward_device = faulty


def half_batch(run):
    """Only the first half of each batch's pairs computed; their answers
    are handed out for the second half too."""
    def change(out, frames):
        n = frames.shape[0]
        h = max(2, n // 4 * 2)
        return tuple(t[torch.arange(n, device=t.device) % h] for t in out)
    _forward(run, change)


def shifted_keypoints(run):
    """Every keypoint handed out one pixel to the right of where the
    pipeline found it."""
    def change(out, frames):
        kp = out[0].clone()
        kp[..., 0] += (out[1] > 0).float()
        out[0] = kp
        return tuple(out)
    _forward(run, change)


def _odd_rolled(t: torch.Tensor) -> torch.Tensor:
    out = t.clone()
    out[1::2] = t[1::2].roll(-1, 0)
    return out


def swapped_partners(run):
    """LightGlue given image 1 of the next pair as pair i's second image."""
    lg = run.pipe.lightglue
    layers, assign = lg.layers, lg.assign
    lg.layers = lambda kpts, desc, valid, hw: layers(_odd_rolled(kpts), _odd_rolled(desc),
                                                     _odd_rolled(valid), hw)
    lg.assign = lambda x, valid: assign(x, _odd_rolled(valid))


def no_matches(run):
    """Every point handed out unmatched (a filter that drops every match)."""
    def change(out, frames):
        out[2] = torch.full_like(out[2], -1)
        out[3] = torch.zeros_like(out[3])
        return tuple(out)
    _forward(run, change)


def skipped_layer(run):
    """The middle LightGlue layer left out."""
    layer = run.pipe.lightglue.transformers[run.cfg["n_layers"] // 2]
    layer.forward = lambda x, enc, bias: x


def row_softmax_cross(run):
    """Every cross block gives image 1 its message through the similarity's
    row softmax (image 0's) where the published block takes the column's."""
    import torch.nn.functional as F

    def messages(qk, v, bias):
        q0, q1 = qk[0::2].float(), qk[1::2].float()
        sim = torch.einsum("bhid,bhjd->bhij", q0, q1) / q0.shape[-1] ** 0.5
        attn01 = F.softmax(sim + bias[1::2].float(), -1)
        m0 = torch.einsum("bhij,bhjd->bhid", attn01, v[1::2].float())
        m1 = torch.einsum("bhij,bhid->bhjd", attn01, v[0::2].float())
        return torch.stack([m0, m1], 1).flatten(0, 1).to(qk.dtype)

    for layer in run.pipe.lightglue.transformers:
        layer.cross_attn.messages = messages


FAULTS = {"half_batch": half_batch, "shifted_keypoints": shifted_keypoints,
          "swapped_partners": swapped_partners, "skipped_layer": skipped_layer,
          "row_softmax_cross": row_softmax_cross, "no_matches": no_matches}


def plant(run) -> None:
    if run.fault is not None:
        FAULTS[run.fault](run)


# ----- analytic counts ---------------------------------------------------------
# Two FLOPs per multiply-accumulate of the work the model defines, whatever
# the program launches to compute it: padded keypoint slots count as
# computed, the cross block's similarity once a layer, the dustbins and the
# elementwise passes not at all.
def superpoint_flops(cfg: dict) -> float:
    """FLOPs of SuperPoint on one frame."""
    h, w = cfg["input_hw"]
    c1, c2, c3, c4 = cfg["superpoint_widths"]
    head, d = cfg["head_width"], cfg["descriptor_dim"]
    total, cin = 0.0, 1
    for i, c in enumerate((c1, c2, c3, c4)):
        s = 2 ** i
        total += conv_flops(cin, c, 3, h // s, w // s) + conv_flops(c, c, 3, h // s, w // s)
        cin = c
    hc, wc = h // 8, w // 8
    return total + (conv_flops(c4, head, 3, hc, wc) + conv_flops(head, 65, 1, hc, wc)
                    + conv_flops(c4, head, 3, hc, wc) + conv_flops(head, d, 1, hc, wc))


def attention_flops(cfg: dict) -> float:
    """FLOPs of one pair's attention: per layer each image's self attention
    (q·kᵀ and the weighted sum, 2·N²·D each) and the cross block's one
    similarity and two weighted sums (2·N²·D each); N the keypoint slots."""
    n, d = cfg["max_num_keypoints"], cfg["descriptor_dim"]
    return cfg["n_layers"] * 14.0 * n * n * d


def lightglue_flops(cfg: dict) -> float:
    """FLOPs of LightGlue on one pair: the position encoding, every layer's
    linear layers and attention, the final projection, similarity and
    matchability."""
    n, d, heads = cfg["max_num_keypoints"], cfg["descriptor_dim"], cfg["num_heads"]
    posenc = 2 * 2.0 * n * 2 * (d // heads // 2)
    # self: Wqkv 6ND², out_proj 2ND², ffn 12ND², each image; cross: to_qk,
    # to_v, to_out 2ND² each and ffn 12ND², each image
    linears = 2 * (6 + 2 + 12) * n * d * d + 2 * (3 * 2 + 12) * n * d * d
    assign = 2 * 2.0 * n * d * d + 2.0 * n * n * d + 2 * 2.0 * n * d
    return posenc + cfg["n_layers"] * linears + attention_flops(cfg) + assign


def flops_per_item(cfg: dict, task: str) -> float:
    """FLOPs of one frame served: SuperPoint on it and half its pair's
    LightGlue."""
    if task != "serve":
        raise ValueError("superpoint_lightglue has no training cell")
    return superpoint_flops(cfg) + lightglue_flops(cfg) / 2
