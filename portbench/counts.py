"""Analytic work counts from a configuration's widths, and the card's peaks.

Two FLOPs per multiply-accumulate of every convolution and matrix product,
counted from the layer shapes the configuration states, whatever the
program launches to compute them. Bytes of a kernel are its inputs read
once and its outputs written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> float:
    return 2.0 * cin * cout * k * k * h * w


def detector_layers(h: int, w: int, widths, head: int, loc: int, ids: int
                    ) -> List[Tuple[str, float]]:
    """(name, FLOPs) of the detector on one (h, w) frame: conv pairs at
    ``widths`` (SAME 3x3) with a 2x2 pool after each of the first three,
    then two heads (3x3 to ``head``, 1x1 to ``loc`` / ``ids``) at h/8."""
    c1, c2, c3, c4 = widths
    out, cin = [], 1
    for i, c in enumerate((c1, c2, c3, c4)):
        s = 2 ** i
        out += [(f"conv{i + 1}a", _conv(cin, c, 3, h // s, w // s)),
                (f"conv{i + 1}b", _conv(c, c, 3, h // s, w // s))]
        cin = c
    hc, wc = h // 8, w // 8
    out += [("convPa", _conv(c4, head, 3, hc, wc)), ("convPb", _conv(head, loc, 1, hc, wc)),
            ("convDa", _conv(c4, head, 3, hc, wc)), ("convDb", _conv(head, ids, 1, hc, wc))]
    return out


def refinenet_layers(patch: int, widths, heatmap: int = 64) -> List[Tuple[str, float]]:
    """(name, FLOPs) of RefineNet on one patch: four VALID 3x3 convs, a 2x2
    pool, two more VALID convs for the 32-px net, SAME conv pairs at 8, 16
    and 32 px around x2 upsamples, a SAME conv and a 1x1 conv at 64 px."""
    c1, c2, c3, c4, c5 = widths
    s = patch
    out = []
    for name, cin, cout in (("conv1a", 1, c1), ("conv1b", c1, c1),
                            ("conv2a", c1, c2), ("conv2b", c2, c2)):
        s -= 2
        out.append((name, _conv(cin, cout, 3, s, s)))
    s //= 2
    if patch == 32:
        for name in ("conv2c", "conv2d"):
            s -= 2
            out.append((name, _conv(c2, c2, 3, s, s)))
    if s != heatmap // 8:
        raise ValueError(f"patch {patch} does not reach the {heatmap // 8}-px bottleneck")
    for name, cin, cout in (("conv3a", c2, c3), ("conv3b", c3, c3)):
        out.append((name, _conv(cin, cout, 3, s, s)))
    for (a, b), cin, cout in ((("conv4a", "conv4b"), c3, c4), (("conv5a", "conv5b"), c4, c5)):
        s *= 2
        out += [(a, _conv(cin, cout, 3, s, s)), (b, _conv(cout, cout, 3, s, s))]
    s *= 2
    out += [("convPa", _conv(c5, c5, 3, s, s)), ("convPb", _conv(c5, 1, 1, s, s))]
    return out


def detector_flops(cfg: dict) -> float:
    """FLOPs of the detector on one frame of the view it sees (the pooled
    view under the hi-res tap)."""
    d = cfg["detector"]
    h, w = (x // cfg.get("hires_scale", 1) for x in cfg["input_hw"])
    return sum(f for _, f in detector_layers(h, w, d["widths"], d["head_width"],
                                             d["loc_classes"], d["id_classes"]))


def refinenet_flops(cfg: dict) -> float:
    """FLOPs of RefineNet on one patch."""
    r = cfg["refinenet"]
    return sum(f for _, f in refinenet_layers(r["patch_size"], r["widths"], r["heatmap"]))


def frame_flops(cfg: dict) -> float:
    """FLOPs of one frame through the pipeline's networks: the detector and
    RefineNet on every one of the ``n_ids`` slots."""
    return detector_flops(cfg) + cfg["n_ids"] * refinenet_flops(cfg)


def train_sample_flops(cfg: dict) -> float:
    """FLOPs of one detector training sample: the forward pass, and a
    backward pass that computes every kernel's gradient and every layer's
    input gradient but the first's (nothing needs the image's)."""
    d = cfg["detector"]
    h, w = cfg["input_hw"]
    layers = detector_layers(h, w, d["widths"], d["head_width"], d["loc_classes"],
                             d["id_classes"])
    return 3.0 * sum(f for _, f in layers) - layers[0][1]


def decode_bytes(cfg: dict, n: int) -> Dict[str, float]:
    """Bytes of the corner decode (B1) on ``n`` frames: the float32 loc and
    ids logits read once, keypoints (float32 pairs) and validity (bool)
    written once."""
    d = cfg["detector"]
    h, w = (x // cfg.get("hires_scale", 1) for x in cfg["input_hw"])
    cells = n * (h // 8) * (w // 8)
    read = cells * (d["loc_classes"] + d["id_classes"]) * 4
    written = n * cfg["n_ids"] * (2 * 4 + 1)
    return {"read": float(read), "written": float(written), "total": float(read + written)}


def decode_min_seconds(cfg: dict, n: int) -> float:
    """The least time of B1 on ``n`` frames: it does no matrix work, so its
    bytes over the card's bandwidth bound it."""
    return decode_bytes(cfg, n)["total"] / HBM_BYTES_PER_S
