"""SuperPoint + LightGlue in plain PyTorch, float32: the reference that the
port (``deepcharuco_tpu_torch.matching``) is held to.

Follows the published code line by line: ``cvg/LightGlue``'s
``lightglue/superpoint.py`` (``SuperPoint._forward``, ``simple_nms``,
``top_k_keypoints``, ``sample_descriptors``) and ``lightglue/lightglue.py``
(``normalize_keypoints``, ``LearnableFourierPositionalEncoding``,
``apply_cached_rotary_emb``, ``SelfBlock``, ``CrossBlock``,
``MatchAssignment``, ``sigmoid_log_double_softmax``, ``filter_matches``),
with these departures:

- functions over a dict of weights (the published modules' state-dict
  names) in place of ``nn.Module``s; one image, or one pair, at a time;
- attention written out (``einsum``, softmax, ``einsum``) in the self block
  as in the cross block, never ``scaled_dot_product_attention``;
- adaptive depth and width off (``depth_confidence`` and
  ``width_confidence`` −1): every layer runs on every point, no point is
  pruned, and the token confidences are not used;
- no resize and no colour conversion: the image is gray in [0, 1] at its
  own size; keypoints and descriptors as the extractor returns them with
  ``max_num_keypoints`` set;
- ``q`` rounds the operands of every convolution and every product inside
  the layers (linear layers, attention's two products): the identity for
  the reference, a lower precision for a control; the assignment
  (``final_proj``, the similarity, ``matchability``) stays float32.

Weights are drawn from a seed (:func:`draw_weights`) until the published
checkpoints (``superpoint_v1.pth``, ``superpoint_lightglue.pth``) are in the
repository. Convolutions and matrix products run without TF32 inside
:func:`float32`, which :func:`extract` and :func:`match` enter. Imports
nothing but torch.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]
W = Dict[str, torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


@contextlib.contextmanager
def float32():
    """Convolutions and matrix products in full float32 (no TF32)."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


# ----- the weight draw ------------------------------------------------------------
def superpoint_shapes(descriptor_dim: int) -> Dict[str, tuple]:
    c1, c2, c3, c4, c5 = 64, 64, 128, 128, 256
    convs = [("conv1a", 1, c1), ("conv1b", c1, c1), ("conv2a", c1, c2), ("conv2b", c2, c2),
             ("conv3a", c2, c3), ("conv3b", c3, c3), ("conv4a", c3, c4), ("conv4b", c4, c4),
             ("convPa", c4, c5), ("convDa", c4, c5)]
    out = {}
    for name, cin, cout in convs:
        out[f"{name}.weight"], out[f"{name}.bias"] = (cout, cin, 3, 3), (cout,)
    out["convPb.weight"], out["convPb.bias"] = (65, c5, 1, 1), (65,)
    out["convDb.weight"], out["convDb.bias"] = (descriptor_dim, c5, 1, 1), (descriptor_dim,)
    return out


def lightglue_shapes(d: int, n_layers: int, num_heads: int) -> Dict[str, tuple]:
    out = {"posenc.Wr.weight": (d // num_heads // 2, 2)}

    def linear(name, i, o):
        out[f"{name}.weight"], out[f"{name}.bias"] = (o, i), (o,)

    def ffn(name):
        linear(f"{name}.0", 2 * d, 2 * d)
        out[f"{name}.1.weight"], out[f"{name}.1.bias"] = (2 * d,), (2 * d,)
        linear(f"{name}.3", 2 * d, d)

    for i in range(n_layers):
        s, c = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        linear(f"{s}.Wqkv", d, 3 * d)
        linear(f"{s}.out_proj", d, d)
        ffn(f"{s}.ffn")
        for part in ("to_qk", "to_v", "to_out"):
            linear(f"{c}.{part}", d, d)
        ffn(f"{c}.ffn")
    a = f"log_assignment.{n_layers - 1}"
    linear(f"{a}.matchability", d, 1)
    linear(f"{a}.final_proj", d, d)
    return out


def draw_weights(conf: dict, seed: int):
    """(SuperPoint's, LightGlue's) float32 state dicts in the published
    layout, drawn on the CPU from one generator seeded with ``seed``:

    - SuperPoint: every conv kernel normal, its mean over its inputs removed
      (the random features answer structure, not the gray level, so that
      the descriptors tell points apart), scaled to the He std √(2/fan_in)
      and, for ``convPb``, times ``weight_draw["scores_gain"]`` (how
      peaked the 65-class softmax is); biases 0;
    - LightGlue: ``posenc.Wr`` normal with std 1 (the published init, γ = 1);
      every linear kernel normal with std 1/√fan_in, times
      ``conf["weight_draw"]["attn_gain"]`` for ``Wqkv`` and ``to_qk`` (how
      peaked attention is), ``ffn_out_gain`` for the last linear of each
      ``ffn`` (the residual's size) and ``final_proj_gain`` for
      ``final_proj`` (the similarity's size); biases 0 but
      ``matchability``'s, ``matchability_bias``; LayerNorm scale 1, shift 0.

    ``conf`` holds ``descriptor_dim``, ``n_layers``, ``num_heads`` and
    ``weight_draw``."""
    g = conf["weight_draw"]
    d, n, h = conf["descriptor_dim"], conf["n_layers"], conf["num_heads"]
    gen = torch.Generator().manual_seed(seed)
    sp = {}
    for k, shape in superpoint_shapes(d).items():
        if k.endswith("weight"):
            fan_in = shape[1] * shape[2] * shape[3]
            w = torch.randn(shape, generator=gen)
            w = w - w.mean(dim=(1, 2, 3), keepdim=True)
            w = w / w.flatten(1).std(1)[:, None, None, None] * (2.0 / fan_in) ** 0.5
            sp[k] = w * (g["scores_gain"] if k == "convPb.weight" else 1.0)
        else:
            sp[k] = torch.zeros(shape)
    last = f"log_assignment.{n - 1}."
    lg = {}
    for k, shape in lightglue_shapes(d, n, h).items():
        if k == "posenc.Wr.weight":
            lg[k] = torch.randn(shape, generator=gen)
        elif ".ffn.1." in k:
            lg[k] = torch.ones(shape) if k.endswith("weight") else torch.zeros(shape)
        elif k.endswith("weight"):
            gain = (g["ffn_out_gain"] if ".ffn.3." in k else
                    g["attn_gain"] if k.endswith(("Wqkv.weight", "to_qk.weight")) else
                    g["final_proj_gain"] if k == last + "final_proj.weight" else 1.0)
            lg[k] = torch.randn(shape, generator=gen) * gain / shape[1] ** 0.5
        elif k == last + "matchability.bias":
            lg[k] = torch.full(shape, float(g["matchability_bias"]))
        else:
            lg[k] = torch.zeros(shape)
    return sp, lg


# ----- SuperPoint -------------------------------------------------------------------
def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    def max_pool(x):
        return F.max_pool2d(x, kernel_size=nms_radius * 2 + 1, stride=1, padding=nms_radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)


def top_k_keypoints(keypoints, scores, k):
    if k >= len(keypoints):
        return keypoints, scores
    scores, indices = torch.topk(scores, k, dim=0, sorted=True)
    return keypoints[indices], scores


def sample_descriptors(keypoints, descriptors, s: int = 8):
    b, c, h, w = descriptors.shape
    keypoints = keypoints - s / 2 + 0.5
    keypoints /= torch.tensor([(w * s - s / 2 - 0.5), (h * s - s / 2 - 0.5)]).to(keypoints)[None]
    keypoints = keypoints * 2 - 1
    descriptors = F.grid_sample(descriptors, keypoints.view(b, 1, -1, 2), mode="bilinear",
                                align_corners=True)
    return F.normalize(descriptors.reshape(b, c, -1), p=2, dim=1)


def superpoint_dense(Wt: W, image: torch.Tensor, q: Quant = identity):
    """image (B, 1, H, W) in [0, 1] → (scores (B, H, W) before NMS, dense
    unit descriptors (B, D, H/8, W/8))."""
    def conv(x, name, pad):
        return F.conv2d(q(x), q(Wt[f"{name}.weight"]), Wt[f"{name}.bias"], padding=pad)

    relu = F.relu
    x = relu(conv(image, "conv1a", 1))
    x = relu(conv(x, "conv1b", 1))
    x = F.max_pool2d(x, 2, 2)
    x = relu(conv(x, "conv2a", 1))
    x = relu(conv(x, "conv2b", 1))
    x = F.max_pool2d(x, 2, 2)
    x = relu(conv(x, "conv3a", 1))
    x = relu(conv(x, "conv3b", 1))
    x = F.max_pool2d(x, 2, 2)
    x = relu(conv(x, "conv4a", 1))
    x = relu(conv(x, "conv4b", 1))

    cPa = relu(conv(x, "convPa", 1))
    scores = conv(cPa, "convPb", 0)
    scores = F.softmax(scores, 1)[:, :-1]
    b, _, h, w = scores.shape
    scores = scores.permute(0, 2, 3, 1).reshape(b, h, w, 8, 8)
    scores = scores.permute(0, 1, 3, 2, 4).reshape(b, h * 8, w * 8)

    cDa = relu(conv(x, "convDa", 1))
    descriptors = conv(cDa, "convDb", 0)
    descriptors = F.normalize(descriptors, p=2, dim=1)
    return scores, descriptors


def superpoint_select(scores: torch.Tensor, conf: dict):
    """Dense scores (B, H, W) → (NMS scores (B, H, W) with the borders at
    −1, [keypoints (k_i, 2) float (x, y)], [their scores])."""
    scores = simple_nms(scores, conf["nms_radius"])
    if conf["remove_borders"]:
        pad = conf["remove_borders"]
        scores[:, :pad] = -1
        scores[:, :, :pad] = -1
        scores[:, -pad:] = -1
        scores[:, :, -pad:] = -1
    b = scores.shape[0]
    best_kp = torch.where(scores > conf["detection_threshold"])
    kp_scores = scores[best_kp]
    keypoints = [torch.stack(best_kp[1:3], dim=-1)[best_kp[0] == i] for i in range(b)]
    kp_scores = [kp_scores[best_kp[0] == i] for i in range(b)]
    keypoints, kp_scores = list(zip(*[top_k_keypoints(k, s, conf["max_num_keypoints"])
                                      for k, s in zip(keypoints, kp_scores)]))
    keypoints = [torch.flip(k, [1]).float() for k in keypoints]
    return scores, keypoints, list(kp_scores)


def extract(Wt: W, image: torch.Tensor, conf: dict, q: Quant = identity) -> dict:
    """SuperPoint on images (B, 1, H, W) in [0, 1]: ``keypoints``,
    ``keypoint_scores``, ``descriptors`` ((k_i, D) per image), and
    ``dense_scores`` (before NMS), ``nms_scores``, ``dense_descriptors``."""
    with float32():
        dense, desc = superpoint_dense(Wt, image, q)
        nms, keypoints, scores = superpoint_select(dense.clone(), conf)
        descriptors = [sample_descriptors(k[None], d[None], 8)[0].t()
                       for k, d in zip(keypoints, desc)]
    return {"keypoints": keypoints, "keypoint_scores": scores, "descriptors": descriptors,
            "dense_scores": dense, "nms_scores": nms, "dense_descriptors": desc}


# ----- LightGlue ----------------------------------------------------------------------
def normalize_keypoints(kpts: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    size = size.to(kpts)
    shift = size / 2
    scale = size.max(-1).values / 2
    return (kpts - shift[..., None, :]) / scale[..., None, None]


def posenc(Wt: W, x: torch.Tensor) -> torch.Tensor:
    projected = F.linear(x, Wt["posenc.Wr.weight"])
    cosines, sines = torch.cos(projected), torch.sin(projected)
    emb = torch.stack([cosines, sines], 0).unsqueeze(-3)
    return emb.repeat_interleave(2, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x.unbind(dim=-1)
    return torch.stack((-x2, x1), dim=-1).flatten(start_dim=-2)


def apply_cached_rotary_emb(freqs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return (t * freqs[0]) + (rotate_half(t) * freqs[1])


def linear(Wt: W, name: str, x: torch.Tensor, q: Quant) -> torch.Tensor:
    return F.linear(q(x), q(Wt[f"{name}.weight"]), Wt[f"{name}.bias"])


def ffn(Wt: W, name: str, x: torch.Tensor, q: Quant) -> torch.Tensor:
    x = linear(Wt, f"{name}.0", x, q)
    x = F.layer_norm(x, (x.shape[-1],), Wt[f"{name}.1.weight"], Wt[f"{name}.1.bias"])
    x = F.gelu(x)
    return linear(Wt, f"{name}.3", x, q)


def attention(q_, k, v, q: Quant):
    s = q_.shape[-1] ** -0.5
    sim = torch.einsum("...id,...jd->...ij", q(q_), q(k)) * s
    attn = F.softmax(sim, -1)
    return torch.einsum("...ij,...jd->...id", q(attn), q(v))


def self_block(Wt: W, name: str, x, encoding, num_heads: int, q: Quant):
    qkv = linear(Wt, f"{name}.Wqkv", x, q)
    qkv = qkv.unflatten(-1, (num_heads, -1, 3)).transpose(1, 2)
    q_, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q_ = apply_cached_rotary_emb(encoding, q_)
    k = apply_cached_rotary_emb(encoding, k)
    context = attention(q_, k, v, q)
    message = linear(Wt, f"{name}.out_proj", context.transpose(1, 2).flatten(start_dim=-2), q)
    return x + ffn(Wt, f"{name}.ffn", torch.cat([x, message], -1), q)


def cross_block(Wt: W, name: str, x0, x1, num_heads: int, q: Quant):
    qk0, qk1 = linear(Wt, f"{name}.to_qk", x0, q), linear(Wt, f"{name}.to_qk", x1, q)
    v0, v1 = linear(Wt, f"{name}.to_v", x0, q), linear(Wt, f"{name}.to_v", x1, q)
    qk0, qk1, v0, v1 = map(lambda t: t.unflatten(-1, (num_heads, -1)).transpose(1, 2),
                           (qk0, qk1, v0, v1))
    scale = qk0.shape[-1] ** -0.5
    qk0, qk1 = qk0 * scale ** 0.5, qk1 * scale ** 0.5
    sim = torch.einsum("bhid, bhjd -> bhij", q(qk0), q(qk1))
    attn01 = F.softmax(sim, dim=-1)
    attn10 = F.softmax(sim.transpose(-2, -1).contiguous(), dim=-1)
    m0 = torch.einsum("bhij, bhjd -> bhid", q(attn01), q(v1))
    m1 = torch.einsum("bhji, bhjd -> bhid", q(attn10.transpose(-2, -1)), q(v0))
    m0, m1 = (t.transpose(1, 2).flatten(start_dim=-2) for t in (m0, m1))
    m0, m1 = linear(Wt, f"{name}.to_out", m0, q), linear(Wt, f"{name}.to_out", m1, q)
    x0 = x0 + ffn(Wt, f"{name}.ffn", torch.cat([x0, m0], -1), q)
    x1 = x1 + ffn(Wt, f"{name}.ffn", torch.cat([x1, m1], -1), q)
    return x0, x1


def sigmoid_log_double_softmax(sim, z0, z1):
    b, m, n = sim.shape
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    scores0 = F.log_softmax(sim, 2)
    scores1 = F.log_softmax(sim.transpose(-1, -2).contiguous(), 2).transpose(-1, -2)
    scores = sim.new_full((b, m + 1, n + 1), 0)
    scores[:, :m, :n] = scores0 + scores1 + certainties
    scores[:, :-1, -1] = F.logsigmoid(-z0.squeeze(-1))
    scores[:, -1, :-1] = F.logsigmoid(-z1.squeeze(-1))
    return scores


def match_assignment(Wt: W, name: str, desc0, desc1):
    mdesc0 = F.linear(desc0, Wt[f"{name}.final_proj.weight"], Wt[f"{name}.final_proj.bias"])
    mdesc1 = F.linear(desc1, Wt[f"{name}.final_proj.weight"], Wt[f"{name}.final_proj.bias"])
    _, _, d = mdesc0.shape
    mdesc0, mdesc1 = mdesc0 / d ** 0.25, mdesc1 / d ** 0.25
    sim = torch.einsum("bmd,bnd->bmn", mdesc0, mdesc1)
    z0 = F.linear(desc0, Wt[f"{name}.matchability.weight"], Wt[f"{name}.matchability.bias"])
    z1 = F.linear(desc1, Wt[f"{name}.matchability.weight"], Wt[f"{name}.matchability.bias"])
    return sigmoid_log_double_softmax(sim, z0, z1), sim


def filter_matches(scores: torch.Tensor, th: float):
    max0, max1 = scores[:, :-1, :-1].max(2), scores[:, :-1, :-1].max(1)
    m0, m1 = max0.indices, max1.indices
    indices0 = torch.arange(m0.shape[1], device=m0.device)[None]
    indices1 = torch.arange(m1.shape[1], device=m1.device)[None]
    mutual0 = indices0 == m1.gather(1, m0)
    mutual1 = indices1 == m0.gather(1, m1)
    max0_exp = max0.values.exp()
    zero = max0_exp.new_tensor(0)
    mscores0 = torch.where(mutual0, max0_exp, zero)
    mscores1 = torch.where(mutual1, mscores0.gather(1, m1), zero)
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & valid0.gather(1, m1)
    m0 = torch.where(valid0, m0, -1)
    m1 = torch.where(valid1, m1, -1)
    return m0, m1, mscores0, mscores1


def match(Wt: W, kpts0, kpts1, desc0, desc1, size, conf: dict, q: Quant = identity) -> dict:
    """LightGlue on one pair: keypoints (m, 2) and (n, 2) in pixels of images
    of ``size`` (w, h), unit descriptors (m, D) and (n, D) → ``scores``
    ((m+1, n+1) log assignment), ``matches0``, ``matches1``,
    ``matching_scores0``, ``matching_scores1`` and ``layers`` (each layer's
    (desc0, desc1))."""
    with float32():
        size = torch.tensor(size, dtype=torch.float32, device=kpts0.device)[None]
        kpts0 = normalize_keypoints(kpts0[None], size).clone()
        kpts1 = normalize_keypoints(kpts1[None], size).clone()
        desc0, desc1 = desc0[None].contiguous(), desc1[None].contiguous()
        encoding0, encoding1 = posenc(Wt, kpts0), posenc(Wt, kpts1)
        layers: List[tuple] = []
        for i in range(conf["n_layers"]):
            name = f"transformers.{i}"
            desc0 = self_block(Wt, f"{name}.self_attn", desc0, encoding0, conf["num_heads"], q)
            desc1 = self_block(Wt, f"{name}.self_attn", desc1, encoding1, conf["num_heads"], q)
            desc0, desc1 = cross_block(Wt, f"{name}.cross_attn", desc0, desc1,
                                       conf["num_heads"], q)
            layers.append((desc0[0], desc1[0]))
        scores, _ = match_assignment(Wt, f"log_assignment.{conf['n_layers'] - 1}",
                                     desc0, desc1)
        m0, m1, mscores0, mscores1 = filter_matches(scores, conf["filter_threshold"])
    return {"scores": scores[0], "matches0": m0[0], "matches1": m1[0],
            "matching_scores0": mscores0[0], "matching_scores1": mscores1[0],
            "layers": layers}
