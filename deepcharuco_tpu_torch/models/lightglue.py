"""LightGlue (Lindenberger, Sarlin, Pollefeys, ICCV 2023, arXiv 2306.13643)
for SuperPoint features, batched over pairs with static shapes, as
``cvg/LightGlue``'s ``lightglue/lightglue.py`` runs it with adaptive depth
and width off (``depth_confidence=-1``, ``width_confidence=-1``: every
layer on every point).

A batch holds 2P images; rows 2i and 2i+1 are pair i, each with ``k``
keypoint slots, of which ``valid`` are real (a frame where fewer survive
SuperPoint's selection is padded, as the published compiled path pads to a
static length). Per pair:

- keypoints normalised by the image size (shift (w/2, h/2), scale
  max(w, h)/2) and encoded by ``LearnableFourierPositionalEncoding``
  (``Wr``: 2 → head_dim/2 without bias; cos and sin each repeated twice);
- ``n_layers`` layers, each a self block on both images (``Wqkv`` laid out
  (heads, head_dim, 3) interleaved, rotary on q and k, attention,
  ``out_proj``, then ``x + ffn([x, m])`` with ``ffn`` Linear 2D → 2D,
  LayerNorm, exact GELU, Linear 2D → D) and one cross block (``to_qk``
  shared by both images, ``to_v``, one similarity a head: its softmax by
  rows gives image 0's message from image 1's values, by columns image 1's
  from image 0's; ``to_out``; the same ``ffn`` residual);
- the assignment: ``final_proj`` over D^¼ on each image, ``sim = m0·m1ᵀ``,
  ``matchability`` logits z; log-softmax over rows + log-softmax over
  columns + logσ(z0) + logσ(z1)ᵀ, then ``filter_matches``: mutual argmax
  with exp(score) above the threshold. The dustbin row and column
  (logσ(−z)) take no part in the matches and are not formed.

The layers run in the module's ``dtype`` (bf16 by default); the position
encoding, the assignment and its softmaxes in float32. Attention is
``torch.nn.functional.scaled_dot_product_attention`` (flash, memory-
efficient or cuDNN on the card, by what the call allows), the cross block's
two directions in one call: image 1's rows attend to image 0 through the
same call with the pair's rows swapped, so the similarity is formed once a
direction. Padded keys get a bias of −10⁴ (its exponential is 0 in float32,
as −∞'s, and a frame without a valid keypoint stays finite).

Spans (``profiling``): ``match.attention`` around each attention call, with
events on the stream on the card. Parameters load from the published
layout through :func:`state_from_published`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepcharuco_tpu_torch import profiling

MASKED = -1e4           # the bias of a padded key, and of a padded pair in the assignment


def normalize_keypoints(kpts: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., 2) pixels (x, y) of an (h, w) image → centred, over max(h, w)/2
    (Python scalars: a tensor made from host values would wait for the
    device)."""
    h, w = hw
    scale = max(h, w) / 2
    return torch.stack([(kpts[..., 0] - w / 2) / scale, (kpts[..., 1] - h / 2) / scale], -1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x2, x1), -1).flatten(-2)


def apply_rotary(enc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t * enc[0] + rotate_half(t) * enc[1]


def partner(t: torch.Tensor) -> torch.Tensor:
    """Rows 2i and 2i+1 swapped: each image's partner in its pair."""
    return t.unflatten(0, (-1, 2)).flip(1).flatten(0, 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Softmax attention of (B, H, N, d) queries over keys with an additive
    (B, 1, 1, N) key bias, in one ``match.attention`` span."""
    with profiling.span("match.attention", device=q.is_cuda):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


def _ffn(d: int, dtype) -> nn.Sequential:
    return nn.Sequential(nn.Linear(2 * d, 2 * d, dtype=dtype),
                         nn.LayerNorm(2 * d, dtype=dtype), nn.GELU(),
                         nn.Linear(2 * d, d, dtype=dtype))


class FourierEncoding(nn.Module):
    """``LearnableFourierPositionalEncoding(2, head_dim)``: (B, N, 2) →
    (2, B, 1, N, head_dim), cos then sin."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.Wr = nn.Linear(2, head_dim // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.Wr(x)
        return torch.stack([p.cos(), p.sin()], 0).unsqueeze(-3).repeat_interleave(2, dim=-1)


class SelfBlock(nn.Module):
    def __init__(self, d: int, heads: int, dtype):
        super().__init__()
        self.heads = heads
        self.Wqkv = nn.Linear(d, 3 * d, dtype=dtype)
        self.out_proj = nn.Linear(d, d, dtype=dtype)
        self.ffn = _ffn(d, dtype)

    def forward(self, x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        qkv = self.Wqkv(x).unflatten(-1, (self.heads, -1, 3)).transpose(1, 2)
        q, k, v = qkv.unbind(-1)
        q, k = apply_rotary(enc, q), apply_rotary(enc, k)
        ctx = attention(q, k, v.contiguous(), bias)
        msg = self.out_proj(ctx.transpose(1, 2).flatten(-2))
        return x + self.ffn(torch.cat([x, msg], -1))


class CrossBlock(nn.Module):
    def __init__(self, d: int, heads: int, dtype):
        super().__init__()
        self.heads = heads
        self.to_qk = nn.Linear(d, d, dtype=dtype)
        self.to_v = nn.Linear(d, d, dtype=dtype)
        self.to_out = nn.Linear(d, d, dtype=dtype)
        self.ffn = _ffn(d, dtype)

    def messages(self, qk: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """(B, H, N, d) messages of every image from its partner: a query row
        of image 0 softmaxes the similarity's row, one of image 1 its
        column."""
        return attention(qk, partner(qk), partner(v), partner(bias))

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        heads = lambda t: t.unflatten(-1, (self.heads, -1)).transpose(1, 2)
        m = self.messages(heads(self.to_qk(x)), heads(self.to_v(x)), bias)
        m = self.to_out(m.transpose(1, 2).flatten(-2))
        return x + self.ffn(torch.cat([x, m], -1))


class TransformerLayer(nn.Module):
    def __init__(self, d: int, heads: int, dtype):
        super().__init__()
        self.self_attn = SelfBlock(d, heads, dtype)
        self.cross_attn = CrossBlock(d, heads, dtype)

    def forward(self, x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.cross_attn(self.self_attn(x, enc, bias), bias)


class MatchAssignment(nn.Module):
    """``final_proj`` and ``matchability`` in float32."""

    def __init__(self, d: int):
        super().__init__()
        self.matchability = nn.Linear(d, 1)
        self.final_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(2P, N, D) descriptors and validity → (P, N, N) float32 log
        assignment of each pair's points, −2·10⁴ or below where a point is
        padded."""
        x = x.float()
        md = self.final_proj(x) / x.shape[-1] ** 0.25
        sim = torch.matmul(md[0::2], md[1::2].transpose(1, 2))
        z = F.logsigmoid(self.matchability(x)[..., 0])
        both = valid[0::2, :, None] & valid[1::2, None, :]
        sim = sim.masked_fill_(~both, MASKED)
        scores = F.log_softmax(sim, 2)
        scores += F.log_softmax(sim, 1)
        scores += z[0::2, :, None]
        scores += z[1::2, None, :]
        return scores


def filter_matches(scores: torch.Tensor, threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(P, M, N) log assignment → (m0 (P, M), m1 (P, N) int64 partner or −1,
    their scores (P, M), (P, N)): mutual argmax with exp(score) above
    ``threshold``, as ``filter_matches`` does."""
    max0, max1 = scores.max(2), scores.max(1)
    m0, m1 = max0.indices, max1.indices
    idx0 = torch.arange(m0.shape[1], device=m0.device)[None]
    idx1 = torch.arange(m1.shape[1], device=m1.device)[None]
    mutual0 = idx0 == m1.gather(1, m0)
    mutual1 = idx1 == m0.gather(1, m1)
    mscores0 = torch.where(mutual0, max0.values.exp(), 0.0)
    mscores1 = torch.where(mutual1, mscores0.gather(1, m1), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    valid1 = mutual1 & valid0.gather(1, m1)
    return (torch.where(valid0, m0, -1), torch.where(valid1, m1, -1), mscores0, mscores1)


class LightGlue(nn.Module):
    """LightGlue's layers and final assignment (module layout as published,
    the last layer's assignment as ``assignment``)."""

    def __init__(self, descriptor_dim: int = 256, n_layers: int = 9, num_heads: int = 4,
                 filter_threshold: float = 0.1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.filter_threshold = filter_threshold
        self.posenc = FourierEncoding(descriptor_dim // num_heads)
        self.transformers = nn.ModuleList(TransformerLayer(descriptor_dim, num_heads, dtype)
                                          for _ in range(n_layers))
        self.assignment = MatchAssignment(descriptor_dim)

    def encode(self, kpts: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor,
               hw: Tuple[int, int]):
        """(descriptors in ``dtype``, rotary encoding in ``dtype``, key bias)
        of keypoints (2P, N, 2) in pixels of (h, w) images, descriptors
        (2P, N, D) and validity (2P, N)."""
        enc = self.posenc(normalize_keypoints(kpts.float(), hw)).to(self.dtype)
        bias = torch.zeros(valid.shape, dtype=self.dtype, device=valid.device)
        bias = bias.masked_fill_(~valid, MASKED)[:, None, None]
        return desc.to(self.dtype), enc, bias

    def layers(self, kpts, desc, valid, hw) -> torch.Tensor:
        """The descriptors after every layer."""
        x, enc, bias = self.encode(kpts, desc, valid, hw)
        for layer in self.transformers:
            x = layer(x, enc, bias)
        return x

    def assign(self, x: torch.Tensor, valid: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(matches (2P, N) int32, match scores (2P, N) float32), one row an
        image: the partner's point matched, or −1 (padded points, points
        whose partner is padded and unmatched ones)."""
        m0, m1, s0, s1 = filter_matches(self.assignment(x, valid), self.filter_threshold)
        matches = torch.stack([m0, m1], 1).flatten(0, 1)
        scores = torch.stack([s0, s1], 1).flatten(0, 1)
        ok = valid & (matches >= 0)
        ok &= partner(valid).gather(1, matches.clamp_min(0))
        return torch.where(ok, matches, -1).int(), torch.where(valid, scores, 0.0)


def state_from_published(sd: Dict[str, torch.Tensor], n_layers: int) -> Dict[str, torch.Tensor]:
    """The published state dict (``transformers.{i}.self_attn.Wqkv.weight``,
    ``log_assignment.{i}.final_proj.weight``, ...) as this module names it:
    the last layer's ``log_assignment`` becomes ``assignment``; the other
    layers' assignments and the token confidences (adaptive depth and width)
    are not used."""
    last = f"log_assignment.{n_layers - 1}."
    out = {}
    for k, v in sd.items():
        if k.startswith(last):
            out["assignment." + k[len(last):]] = v
        elif not k.startswith(("log_assignment.", "token_confidence.")):
            out[k] = v
    return out
