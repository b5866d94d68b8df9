"""The conv epilogue (``ops.conv_epilogue``, ``csrc/conv_epilogue.cu``)
against the ATen chain it replaces: conv bias add → ``F.batch_norm`` →
``F.relu`` → ``F.max_pool2d`` / nearest ×2.

The CPU tests hold the plain version to the chain bit for bit, and the
models' outputs (which keep the chain on the CPU) to the chain as the
models ran it before the epilogue. The card tests (marked ``cuda``; each
skips from inside the test where there is no CUDA device) hold the kernel
to the chain bit for bit, block by block and model by model, count its
launches, and check what the wrapper refuses: ``python -m pytest
--noconftest tests/test_torch_conv_epilogue.py -q`` on a machine with the
card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepcharuco_tpu_torch import profiling
from deepcharuco_tpu_torch.models import Detector, RefineNet
from deepcharuco_tpu_torch.models.detector import as_f32, to_nchw, to_nhwc
from deepcharuco_tpu_torch.ops import conv_epilogue

FRAMES = "tests/data/torch_port_frames.npz"
LAUNCHES = "kernels.epilogue_launches"
THENS = [None, "pool", "up"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def launches() -> int:
    return profiling.counters().get(LAUNCHES, 0)


# ----------------------------------------------------------------- the chain

def chain_follow(x, then):
    """The ATen step after a block: pool, nearest or bilinear ×2, or none."""
    if then == "pool":
        return F.max_pool2d(x, 2, 2)
    if then == "up":
        return F.interpolate(x, scale_factor=2, mode="nearest")
    if then == "bilinear":
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    return x


def chain_bias_relu(c, conv_bias, then):
    """What the chain does to a conv output ``c`` without its bias in a
    block with no norm (SuperPoint's)."""
    c = c.clone()
    c.add_(conv_bias.view(1, -1, 1, 1))
    return chain_follow(F.relu(c), then)


def chain_epilogue(c, conv_bias, bn, then):
    """What the chain does to a conv output ``c`` without its bias."""
    c = c.clone()
    c.add_(conv_bias.view(1, -1, 1, 1))                 # as ATen does after cuDNN
    y = F.batch_norm(c, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                     bn.eps)
    return chain_follow(F.relu(y), then)


def chain_block(m, x, then=None):
    """A ConvBNRelu block as the chain runs it: conv with bias, BatchNorm,
    ReLU, then ``then``."""
    bn = m.bn
    y = F.conv2d(x, m.conv.weight, m.conv.bias, padding=m.conv.padding)
    y = F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                     bn.eps)
    return chain_follow(F.relu(y), then)


def walk_detector(det, x, block, trunk_only=False):
    """The detector's graph with each block run by ``block(m, x, then)``."""
    x = to_nchw(x.to(det.dtype))
    x = block(det.conv1b, block(det.conv1a, x, None), "pool")
    x = block(det.conv2b, block(det.conv2a, x, None), "pool")
    x = block(det.conv3b, block(det.conv3a, x, None), "pool")
    x = block(det.conv4b, block(det.conv4a, x, None), None)
    if trunk_only:
        return {"trunk": to_nhwc(x)}
    loc = det.convPb(block(det.convPa, x, None))
    ids = det.convDb(block(det.convDa, x, None))
    return {"loc": to_nhwc(as_f32(loc)), "ids": to_nhwc(as_f32(ids))}


def walk_refinenet(rn, x, block):
    """RefineNet's graph with each block run by ``block(m, x, then)``; the
    bilinear upsample is the block's ``then="bilinear"``."""
    up = "bilinear" if rn.upsample == "bilinear" else "up"
    x = to_nchw(x.to(rn.dtype))
    x = block(rn.conv2a, block(rn.conv1b, block(rn.conv1a, x, None), None), None)
    x = block(rn.conv2b, x, "pool")
    if rn.patch_size == 32:
        x = block(rn.conv2d, block(rn.conv2c, x, None), None)
    x = block(rn.conv3a, x, None)
    if rn.offset_head:
        bottleneck = block(rn.conv3b, x, None)
        x = chain_follow(bottleneck, up)
    else:
        x = block(rn.conv3b, x, up)
    x = block(rn.conv4b, block(rn.conv4a, x, None), up)
    x = block(rn.conv5b, block(rn.conv5a, x, None), up)
    heat = to_nhwc(as_f32(rn.convPb(block(rn.convPa, x, None))))
    if not rn.offset_head:
        return heat
    o = to_nhwc(block(rn.convOa, bottleneck, "pool")).flatten(1)
    return {"heat": heat, "offset": as_f32(rn.denseOb(F.relu(rn.denseOa(o))))}


def randomize_bn(model, seed):
    """Non-trivial running statistics and affine parameters in every block."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
            m.running_var.copy_(torch.rand(c, generator=g) * 2 + 0.05)
            m.weight.data.copy_(torch.rand(c, generator=g) + 0.5)
            m.bias.data.copy_(torch.randn(c, generator=g) * 0.2)
    return model


def equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(equal(a[k], b[k]) for k in a)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


RN_VARIANTS = [dict(patch_size=p, offset_head=o, upsample=u)
               for p in (24, 32) for o in (False, True) for u in ("nearest", "bilinear")]
RN_IDS = [f"{v['patch_size']}px-{'offset' if v['offset_head'] else 'heat'}-{v['upsample']}"
          for v in RN_VARIANTS]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


# ------------------------------------------------------------------ the CPU

def conv_output(rng, n, c, h, w, dtype):
    """A conv output (N, C, H, W) channels_last: normal values, some exact
    zeros and values near the BatchNorm's shift."""
    x = rng.normal(size=(n, h, w, c)).astype(np.float32) * 2
    x[rng.random(x.shape) < 0.05] = 0.0
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


def block_params(c, dtype, seed):
    """A conv bias and an eval BatchNorm with random statistics."""
    g = torch.Generator().manual_seed(seed + 1)
    bn = randomize_bn(torch.nn.BatchNorm2d(c, eps=1e-5), seed).eval()
    return (torch.randn(c, generator=g) * 0.5).to(dtype), bn


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("then", THENS, ids=["none", "pool", "up"])
@pytest.mark.parametrize("hw", [(6, 10), (7, 9)], ids=["even", "odd"])
def test_plain_equals_the_chain(dtype, c, then, hw):
    """Bias add, BatchNorm, ReLU and the pool (floor, odd sizes too) or the
    nearest ×2, bit for bit, on the CPU."""
    rng = np.random.default_rng(c + hw[0])
    x = conv_output(rng, 2, c, *hw, DTYPES[dtype])
    bias, bn = block_params(c, DTYPES[dtype], c)
    got = conv_epilogue.epilogue_plain(x, bias, bn.running_mean, bn.running_var, bn.weight,
                                       bn.bias, bn.eps, then)
    want = chain_epilogue(x, bias, bn, then)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert equal(got, want.contiguous(memory_format=torch.channels_last))
    # the wrapper takes the plain version for a CPU tensor, and counts nothing
    before = launches()
    again = conv_epilogue.epilogue(x, bias, bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, bn.eps, then)
    assert equal(again, got) and launches() == before


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("hw", [(40, 56), (36, 44)], ids=["even", "odd-trunk"])
def test_detector_on_the_cpu_equals_the_chain(dtype, hw):
    """The detector's heads and trunk equal the chain's, bit for bit; at 36×44
    the third pool meets a 9×11 map. No launch is counted."""
    torch.manual_seed(0)
    det = randomize_bn(Detector(16, DTYPES[dtype]), 1).eval()
    x = torch.rand(2, *hw, 1) - 0.5
    before = launches()
    with torch.inference_mode():
        for trunk_only in (False, True):
            got = det(x, trunk_only=trunk_only)
            want = walk_detector(det, x, chain_block, trunk_only)
            assert equal(got, want)
    assert launches() == before


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("variant", RN_VARIANTS, ids=RN_IDS)
def test_refinenet_on_the_cpu_equals_the_chain(dtype, variant):
    torch.manual_seed(1)
    rn = randomize_bn(RefineNet(DTYPES[dtype], **variant), 2).eval()
    p = variant["patch_size"]
    x = torch.rand(3, p, p, 1) - 0.5
    before = launches()
    with torch.inference_mode():
        assert equal(rn(x), walk_refinenet(rn, x, chain_block))
    assert launches() == before


@pytest.mark.parametrize("model", ["detector", "refinenet"])
def test_training_forward_follows_the_block_with_its_pool_or_upsample(model):
    """``train=True`` keeps the written-out BatchNorm and applies ``then``
    after it: the same outputs and running statistics as the block followed
    by ATen's pool or upsample, and no launch."""
    torch.manual_seed(2)
    make = (lambda: Detector(16, torch.float32)) if model == "detector" else \
        (lambda: RefineNet(torch.float32, patch_size=32, offset_head=True))
    a, b = make(), make()
    b.load_state_dict(a.state_dict())
    shape = (2, 32, 48, 1) if model == "detector" else (2, 32, 32, 1)
    x = torch.rand(*shape) - 0.5

    def train_block(m, x, then):
        return chain_follow(m(x, train=True), then)

    before = launches()
    got = a(x, train=True)
    want = (walk_detector if model == "detector" else walk_refinenet)(b, x, train_block)
    assert launches() == before
    assert equal(got, want)
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k


def test_then_must_be_named():
    x = torch.zeros(1, 8, 2, 2).contiguous(memory_format=torch.channels_last)
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="then must be one of"):
        conv_epilogue.epilogue(x, z, z, z + 1, z, z, 1e-5, "bilinear")


# ----------------------------------------------------------------- the card

def fixture_inputs(dev):
    """The fixture's frames, normalized, and 24- and 32-px patches around the
    stored JAX keypoints (128 of each), tiled to 512."""
    from deepcharuco_tpu_torch.ops.image import normalize_gray
    from deepcharuco_tpu_torch.ops.patches import extract_patches

    fix = np.load(FRAMES)
    gray = normalize_gray(torch.from_numpy(fix["frames"]).to(dev))
    kp = torch.from_numpy(fix["keypoints_bf16"]).to(dev)
    patches = {p: extract_patches(gray, kp, p).reshape(-1, p, p, 1).repeat(4, 1, 1, 1)
               for p in (24, 32)}
    return gray, patches


def card_models(dev):
    """The shipped detector, RefineNet-24 and RefineNet-32 (offset branch) in
    bf16, and the 32-px net without the branch with random BatchNorm."""
    from deepcharuco_tpu_torch.weights import load_detector, load_refinenet

    torch.manual_seed(3)
    return {
        "detector": load_detector("artifacts/detector_devsynth.npz", dtype=torch.bfloat16,
                                  device=dev),
        "rn24": load_refinenet("artifacts/refinenet_devsynth.npz", dtype=torch.bfloat16,
                               device=dev),
        "rn32-offset": load_refinenet("artifacts/refinenet32_devsynth.npz",
                                      dtype=torch.bfloat16, device=dev),
        "rn32": randomize_bn(RefineNet(torch.bfloat16, patch_size=32), 4).to(dev).eval(),
    }


BLOCKS = {"detector": 10, "rn24": 11, "rn32-offset": 14, "rn32": 13}


CARD_SHAPES = {"trunk": (256, 30, 40), "odd": (3, 7, 9), "pixel": (1, 1, 1),
               "patches": (513, 8, 8)}
CARD_CASES = [(c, then, shape) for c in (64, 128, 256) for then in THENS
              for shape in CARD_SHAPES if not (then == "pool" and shape == "pixel")]


def card_conv_output(c, shape, card):
    """:func:`conv_output` on the card with NaN, ±inf, −0 and a value near
    bf16's largest planted in it."""
    n, h, w = CARD_SHAPES[shape]
    x = conv_output(np.random.default_rng(c * 7 + h), n, c, h, w, torch.bfloat16)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 3e38],
                            dtype=torch.bfloat16)
    x.permute(0, 2, 3, 1).view(-1)[torch.arange(specials.numel()) * 7] = specials
    return x.to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("c,then,shape", CARD_CASES,
                         ids=[f"{c}-{t or 'none'}-{s}" for c, t, s in CARD_CASES])
def test_kernel_equals_the_chain_on_the_card(card, c, then, shape):
    """Random conv outputs with exact zeros, NaN, ±inf and a value near
    bf16's largest: the kernel's output equals the chain's bit for bit (up
    to the sign of a zero, which ``torch.equal`` ignores), and a second
    launch gives the same bits."""
    x = card_conv_output(c, shape, card)
    bias, bn = block_params(c, torch.bfloat16, c)
    bias, bn = bias.to(card), bn.to(card)
    before = launches()
    got = conv_epilogue.epilogue(x, bias, bn.running_mean, bn.running_var, bn.weight,
                                 bn.bias, bn.eps, then)
    again = conv_epilogue.epilogue(x, bias, bn.running_mean, bn.running_var, bn.weight,
                                   bn.bias, bn.eps, then)
    want = chain_epilogue(x, bias, bn, then)
    torch.cuda.synchronize()
    assert launches() == before + 2
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("c,then,shape", CARD_CASES,
                         ids=[f"{c}-{t or 'none'}-{s}" for c, t, s in CARD_CASES])
def test_no_norm_kernel_equals_the_chain_on_the_card(card, c, then, shape):
    """The entry without BatchNorm (``bias_relu``): the kernel's output
    equals the chain's and ``bias_relu_plain``'s on the card bit for bit,
    and a second launch gives the same bits."""
    x = card_conv_output(c, shape, card)
    bias = block_params(c, torch.bfloat16, c)[0].to(card)
    before = launches()
    got = conv_epilogue.bias_relu(x, bias, then)
    again = conv_epilogue.bias_relu(x, bias, then)
    want = chain_bias_relu(x, bias, then)
    plain = conv_epilogue.bias_relu_plain(x, bias, then)
    torch.cuda.synchronize()
    assert launches() == before + 2
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and torch.equal(torch.isnan(plain), nan)
    assert torch.equal(got[~nan], want[~nan]) and torch.equal(got[~nan], plain[~nan])
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.cuda
def test_every_block_of_superpoint_equals_the_chain_on_the_card(card):
    """SuperPoint's ten blocks on two 480×640 frames: each block's kernel
    output equals conv2d with its bias, ReLU and the pool, and one forward
    counts one launch a block."""
    from deepcharuco_tpu_torch.models import SuperPoint

    torch.manual_seed(3)
    sp = SuperPoint(256).to(card).eval()
    x = torch.rand(2, 480, 640, device=card)

    def both(m, x, then=None):
        got = m(x, then=then)
        want = chain_follow(F.relu(F.conv2d(x, m.conv.weight, m.conv.bias, padding=1)), then)
        assert equal(got, want), (tuple(x.shape), then)
        return got

    with torch.inference_mode():
        trunk = sp.trunk(to_nchw(x.to(torch.bfloat16)[..., None]), both)
        both(sp.convPa, trunk)
        both(sp.convDa, trunk)
        before = launches()
        sp(x)
        torch.cuda.synchronize()
        assert launches() - before == 10


@pytest.mark.cuda
def test_every_block_of_both_models_equals_the_chain_on_the_card(card):
    """On the fixture's frames and patches, each block's kernel output equals
    the chain's on the same input, and each model's forward equals the
    chain's, bit for bit; one forward counts one launch per block."""
    gray, patches = fixture_inputs(card)
    models = card_models(card)

    def both(m, x, then):
        want = chain_block(m, x, then)
        if then == "bilinear":
            got = chain_follow(m(x), then)
        else:
            got = m(x, then=then)
        assert equal(got, want), (type(m).__name__, tuple(x.shape), then)
        return want

    with torch.inference_mode():
        for name, model in models.items():
            x = gray if name == "detector" else patches[model.patch_size]
            walk = walk_detector if name == "detector" else walk_refinenet
            walk(model, x, both)
            before = launches()
            got = model(x)
            torch.cuda.synchronize()
            assert launches() - before == BLOCKS[name], name
            assert equal(got, walk(model, x, chain_block)), name
        before = launches()
        models["detector"](gray, trunk_only=True)
        assert launches() - before == 8


@pytest.mark.cuda
def test_fallbacks_launch_nothing_on_the_card(card):
    """float32 modules, ``train=True`` and a forward with autograd on keep
    the chain and count no launch."""
    torch.manual_seed(5)
    det32 = randomize_bn(Detector(16, torch.float32), 6).to(card).eval()
    det16 = randomize_bn(Detector(16, torch.bfloat16), 6).to(card).eval()
    rn32 = randomize_bn(RefineNet(torch.float32, patch_size=32), 7).to(card).eval()
    x = torch.rand(2, 32, 48, 1, device=card) - 0.5
    p = torch.rand(4, 32, 32, 1, device=card) - 0.5
    before = launches()
    with torch.inference_mode():
        det32(x)
        rn32(p)
    det16(x)                         # autograd on: the kernel has no backward
    det16.train()(x, train=True)
    torch.cuda.synchronize()
    assert launches() == before


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(card):
    c = 64
    bias, bn = block_params(c, torch.bfloat16, 0)
    bn, bias = bn.to(card), bias.to(card)
    args = (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
    x = torch.rand(2, c, 6, 6, device=card, dtype=torch.bfloat16)      # NCHW contiguous
    with pytest.raises(ValueError, match="channels_last"):
        conv_epilogue.epilogue(x, bias, *args)
    cl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="bf16 channels_last"):
        conv_epilogue.epilogue(cl.float(), bias, *args)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_epilogue.epilogue(cl[:, :60].contiguous(memory_format=torch.channels_last),
                               bias[:60], *(a[:60] for a in args[:4]), bn.eps)
    with pytest.raises(ValueError, match="conv bias"):
        conv_epilogue.epilogue(cl, bias.cpu(), *args)
    with pytest.raises(ValueError, match="BatchNorm tensors"):
        conv_epilogue.epilogue(cl, bias, bn.running_mean.cpu(), *args[1:])
    with pytest.raises(ValueError, match="BatchNorm tensors"):
        conv_epilogue.epilogue(cl, bias, bn.running_mean.double(), *args[1:])


@pytest.mark.cuda
def test_the_no_norm_wrapper_refuses_what_the_kernel_does_not_take(card):
    c = 64
    bias = block_params(c, torch.bfloat16, 0)[0].to(card)
    x = torch.rand(2, c, 6, 6, device=card, dtype=torch.bfloat16)      # NCHW contiguous
    with pytest.raises(ValueError, match="channels_last"):
        conv_epilogue.bias_relu(x, bias)
    cl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="bf16 channels_last"):
        conv_epilogue.bias_relu(cl.float(), bias)
    with pytest.raises(ValueError, match="multiple of 8"):
        conv_epilogue.bias_relu(cl[:, :60].contiguous(memory_format=torch.channels_last),
                                bias[:60])
    with pytest.raises(ValueError, match="conv bias"):
        conv_epilogue.bias_relu(cl, bias.cpu())
    with pytest.raises(ValueError, match="conv bias"):
        conv_epilogue.bias_relu(cl, bias.float())
    with pytest.raises(ValueError, match="then must be"):
        conv_epilogue.bias_relu(cl, bias, "bilinear")
