"""SuperPoint + LightGlue in the port (``models.superpoint``,
``ops.keypoints``, ``models.lightglue``, ``matching.MatchPipeline``) against
the plain reference ``reference/superpoint_lightglue.py`` on seeded weights,
at a small size on the CPU: 64×96 frames, descriptor width 64, 2 heads,
2 layers, 64 keypoints. The port runs in float32 here, so that rounding
leaves the comparison tight; bf16 is the benchmark's to judge on the card.

Also the block without BatchNorm against conv + bias + ReLU (+ pool), the
BatchNorm block's bit-equality with the ATen chain, and one card test at
the published widths (marked ``cuda``; it skips from inside the test
without a card)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepcharuco_tpu_torch.matching import MatchPipeline
from deepcharuco_tpu_torch.models import Detector
from deepcharuco_tpu_torch.models.detector import ConvBNRelu, to_nchw
from deepcharuco_tpu_torch.models.lightglue import filter_matches
from deepcharuco_tpu_torch.ops import conv_epilogue
from deepcharuco_tpu_torch.ops import keypoints as kp
from reference import superpoint_lightglue as R

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
H, W = 64, 96
CONF = dict(descriptor_dim=64, n_layers=2, num_heads=2, nms_radius=4,
            detection_threshold=0.0005, remove_borders=4, max_num_keypoints=64,
            filter_threshold=0.1,
            weight_draw=json.loads((ROOT / "portbench/configs/splg_480x640.json").read_text())
            ["weight_draw"])
SEED = 2**31 + 11


def pipeline(conf=CONF, dtype=torch.float32, device=CPU, seed=SEED):
    sp, lg = R.draw_weights(conf, seed)
    return MatchPipeline(sp, lg, max_num_keypoints=conf["max_num_keypoints"],
                         nms_radius=conf["nms_radius"],
                         detection_threshold=conf["detection_threshold"],
                         remove_borders=conf["remove_borders"],
                         descriptor_dim=conf["descriptor_dim"], n_layers=conf["n_layers"],
                         num_heads=conf["num_heads"], filter_threshold=conf["filter_threshold"],
                         compute_dtype=dtype, device=device), sp, lg


def pair_frames(n_pairs=2, hw=(H, W), seed=5):
    """Pairs of the benchmark's protocol: a frame and its homography warp."""
    from portbench.drivers import offline_pairs as D

    params = dict(background=90, roll_max=32, noise=25, warp=0.15)
    return D.pair_pool(seed, hw, 2 * n_pairs, 1, params)[0]


def as_set(xy):
    return {tuple(p) for p in np.asarray(xy).astype(int).tolist()}


@pytest.fixture(scope="module")
def run():
    """The port and the reference on two pairs: the port's outputs, its
    intermediate tensors, and the reference's extraction."""
    pipe, sp, lg = pipeline()
    frames = pair_frames()
    x = torch.from_numpy(frames)
    with torch.no_grad():
        logits, dense = pipe.superpoint(x.float() / 255.0)
        kpts, kscores, valid, desc = pipe.keypoints(logits, dense)
        out = pipe.forward_device(x)
    ex = R.extract(sp, x.float()[:, None] / 255.0, CONF)
    return dict(pipe=pipe, lg=lg, frames=frames, logits=logits, dense=dense, kpts=kpts,
                kscores=kscores, valid=valid, desc=desc, out=out, ex=ex)


def test_the_benchmarks_copy_of_the_reference_is_this_one():
    a = (ROOT / "reference/superpoint_lightglue.py").read_bytes()
    b = (ROOT / "portbench/reference/superpoint_lightglue.py").read_bytes()
    assert hashlib.sha256(a).digest() == hashlib.sha256(b).digest()


def test_score_map_and_nms_keypoints(run):
    ex = run["ex"]
    scores = kp.score_map(run["logits"])
    torch.testing.assert_close(scores, ex["dense_scores"], rtol=1e-5, atol=1e-7)
    for i in range(len(run["frames"])):
        v = run["valid"][i]
        assert as_set(run["kpts"][i][v]) == as_set(ex["keypoints"][i])
        got = sorted(run["kscores"][i][v].tolist())
        torch.testing.assert_close(torch.tensor(got), ex["keypoint_scores"][i].sort().values,
                                   rtol=1e-5, atol=1e-7)


def test_simple_nms_equals_the_published_one_on_ties():
    s = torch.rand(3, 24, 40)
    s[:, 5:9, 5:9] = 0.99                                 # a plateau
    s[1, 10, 10] = s[1, 10, 13] = 0.995                   # two equal maxima within r
    torch.testing.assert_close(kp.simple_nms(s, 4), R.simple_nms(s, 4), rtol=0, atol=0)


def test_sampled_descriptors(run):
    ex = run["ex"]
    dense = F.normalize(run["dense"], p=2, dim=1)
    # float32 convolutions on channels_last tensors sum in another order
    # than the reference's NCHW ones: a few units of 1e-6 on unit vectors
    torch.testing.assert_close(dense, ex["dense_descriptors"], rtol=1e-5, atol=1e-5)
    for i in range(len(run["frames"])):
        v = run["valid"][i]
        ref = R.sample_descriptors(run["kpts"][i][v][None], ex["dense_descriptors"][i:i + 1])
        torch.testing.assert_close(run["desc"][i][v], ref[0].t(), rtol=1e-5, atol=1e-5)


def reference_on_port_keypoints(run, p):
    a, b = 2 * p, 2 * p + 1
    va, vb = run["valid"][a], run["valid"][b]
    ka, kb = run["kpts"][a][va], run["kpts"][b][vb]
    return R.match(run["lg"], ka, kb, run["desc"][a][va], run["desc"][b][vb], (W, H), CONF)


def test_every_layer_output(run):
    lg, pipe = run["lg"], run["pipe"].lightglue
    with torch.no_grad():
        x, enc, bias = pipe.encode(run["kpts"], run["desc"], run["valid"], (H, W))
        outs = []
        for layer in pipe.transformers:
            x = layer(x, enc, bias)
            outs.append(x)
    for p in range(2):
        ref = reference_on_port_keypoints(run, p)
        for i, (d0, d1) in enumerate(ref["layers"]):
            torch.testing.assert_close(outs[i][2 * p][run["valid"][2 * p]], d0,
                                       rtol=1e-4, atol=1e-5, msg=f"layer {i} image 0")
            torch.testing.assert_close(outs[i][2 * p + 1][run["valid"][2 * p + 1]], d1,
                                       rtol=1e-4, atol=1e-5, msg=f"layer {i} image 1")


def test_assignment_matrix(run):
    pipe = run["pipe"].lightglue
    with torch.no_grad():
        x = pipe.layers(run["kpts"], run["desc"], run["valid"], (H, W))
        scores = pipe.assignment(x, run["valid"])
    for p in range(2):
        ref = reference_on_port_keypoints(run, p)["scores"][:-1, :-1]
        va, vb = run["valid"][2 * p], run["valid"][2 * p + 1]
        torch.testing.assert_close(scores[p][va][:, vb], ref, rtol=1e-4, atol=1e-4)


def test_filter_matches_equals_the_published_one():
    g = torch.Generator().manual_seed(3)
    for scale in (1.0, 8.0, 30.0):
        s = torch.randn(4, 33, 41, generator=g) * scale
        s[0, 3, :] = s[0, 3, 7] = 5.0 * scale          # a row of ties
        padded = torch.cat([s, torch.zeros(4, 33, 1)], 2)
        padded = torch.cat([padded, torch.zeros(4, 1, 42)], 1)
        for got, want in zip(filter_matches(s, 0.1), R.filter_matches(padded, 0.1)):
            assert torch.equal(got, want)


def test_matches_and_scores_end_to_end(run):
    out = run["out"]
    for p in range(2):
        ref = reference_on_port_keypoints(run, p)
        for i, key, mkey in ((2 * p, "matches0", "matching_scores0"),
                             (2 * p + 1, "matches1", "matching_scores1")):
            v = run["valid"][i]
            assert torch.equal(out[2][i][v].long(), ref[key])
            torch.testing.assert_close(out[3][i][v], ref[mkey], rtol=1e-4, atol=1e-5)
    matched = sum(int((out[2][i] >= 0).sum()) for i in range(4))
    assert matched > 0, "the weight draw must leave some points matched"


def test_a_pair_with_padded_keypoints():
    """Fewer keypoints than slots survive the threshold: the padded slots
    hold nothing, take no part in attention or the assignment, and the rest
    equals the reference run on the surviving keypoints alone."""
    conf = dict(CONF, detection_threshold=0.04)
    pipe, sp, lg = pipeline(conf)
    frames = pair_frames(seed=9)
    x = torch.from_numpy(frames)
    out = pipe.match(frames)
    ex = R.extract(sp, x.float()[:, None] / 255.0, conf)
    counts = [len(k) for k in ex["keypoints"]]
    assert all(0 < c < conf["max_num_keypoints"] for c in counts), counts
    for p in range(2):
        a, b = 2 * p, 2 * p + 1
        for i in (a, b):
            v = out[1][i] > 0
            assert v.sum() == counts[i] and not v[counts[i]:].any()
            assert as_set(out[0][i][v]) == as_set(ex["keypoints"][i])
            assert (out[2][i][~v] == -1).all() and (out[3][i][~v] == 0).all()
            assert (out[0][i][~v] == 0).all()
        ka, kb = torch.from_numpy(out[0][a][:counts[a]]), torch.from_numpy(out[0][b][:counts[b]])
        da = R.sample_descriptors(ka[None], ex["dense_descriptors"][a:a + 1])[0].t()
        db = R.sample_descriptors(kb[None], ex["dense_descriptors"][b:b + 1])[0].t()
        ref = R.match(lg, ka, kb, da, db, (W, H), conf)
        assert np.array_equal(out[2][a][:counts[a]], ref["matches0"].numpy())
        assert np.array_equal(out[2][b][:counts[b]], ref["matches1"].numpy())
        np.testing.assert_allclose(out[3][a][:counts[a]], ref["matching_scores0"].numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_bf16_pipeline_runs_and_agrees_on_most_keypoints():
    pipe, sp, _ = pipeline(dtype=torch.bfloat16)
    frames = pair_frames()
    out = pipe.match(frames)
    ex = R.extract(sp, torch.from_numpy(frames).float()[:, None] / 255.0, CONF)
    for i in range(len(frames)):
        got = as_set(out[0][i][out[1][i] > 0])
        assert len(got & as_set(ex["keypoints"][i])) >= 0.8 * len(got)
    assert out[2].dtype == np.int32 and out[3].dtype == np.float32


def test_forward_device_refuses_odd_batches():
    pipe, _, _ = pipeline()
    with pytest.raises(ValueError, match="pairs"):
        pipe.forward_device(torch.zeros(3, H, W, dtype=torch.uint8))


# ----- the conv block without BatchNorm, and the one with it ------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("then", [None, "pool", "up"], ids=["none", "pool", "up"])
@pytest.mark.parametrize("hw", [(6, 10), (7, 9)], ids=["even", "odd"])
def test_no_norm_block_is_conv_bias_relu_then(dtype, then, hw):
    torch.manual_seed(0)
    blk = ConvBNRelu(16, 32, 1, dtype, norm=False).eval()
    assert blk.bn is None and "bn.weight" not in blk.state_dict()
    x = torch.randn(2, 16, *hw).to(dtype).contiguous(memory_format=torch.channels_last)
    want = F.relu(F.conv2d(x, blk.conv.weight, blk.conv.bias, padding=1))
    want = (F.max_pool2d(want, 2, 2) if then == "pool" else
            F.interpolate(want, scale_factor=2, mode="nearest") if then == "up" else want)
    with torch.no_grad():
        got = blk(x, then=then)
    assert torch.equal(got, want)
    c = F.conv2d(x, blk.conv.weight, None, padding=1)
    plain = conv_epilogue.bias_relu_plain(c, blk.conv.bias, then)
    chain = F.relu(c + blk.conv.bias.view(1, -1, 1, 1))
    chain = (F.max_pool2d(chain, 2, 2) if then == "pool" else
             F.interpolate(chain, scale_factor=2, mode="nearest") if then == "up" else chain)
    assert torch.equal(plain, chain) and plain.is_contiguous(memory_format=torch.channels_last)


def test_no_norm_block_trains_as_conv_relu():
    torch.manual_seed(1)
    blk = ConvBNRelu(4, 8, 1, torch.float32, norm=False)
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    blk(x, train=True, then="pool").sum().backward()
    ref = F.max_pool2d(F.relu(F.conv2d(x, blk.conv.weight, blk.conv.bias, padding=1)), 2)
    assert x.grad is not None and torch.equal(blk(x, train=True, then="pool"), ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_batchnorm_detector_stays_bit_equal_to_the_aten_chain(dtype):
    """The BatchNorm detector, walked by ``Detector.trunk``, equals the ATen
    chain block by block (conv with bias, BatchNorm, ReLU, then the pool)
    bit for bit on the fixture's frames, and the BatchNorm epilogue's plain
    version still equals that chain's formula."""
    from deepcharuco_tpu_torch.pipeline import load_model_variables
    from deepcharuco_tpu_torch.weights import detector_state_dict, load_state

    det = load_state(Detector(16, dtype), detector_state_dict(load_model_variables(
        str(ROOT / "artifacts/detector_devsynth.npz"), "detector", 16))).eval()
    with np.load(ROOT / "tests/data/torch_port_frames.npz") as z:
        key = next(k for k in z.files if z[k].dtype == np.uint8 and z[k].ndim == 3)
        frames = z[key][:4]
    x = torch.from_numpy(((frames.astype(np.float32) - 128.0) / 255.0)[..., None])

    def block(m, x, then=None):
        bn = m.bn
        y = F.batch_norm(F.conv2d(x, m.conv.weight, m.conv.bias, padding=1), bn.running_mean,
                         bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)
        y = F.relu(y)
        return F.max_pool2d(y, 2, 2) if then == "pool" else y

    with torch.no_grad():
        got = det(x)
        h = to_nchw(x.to(dtype))
        h = block(det.conv1b, block(det.conv1a, h), "pool")
        h = block(det.conv2b, block(det.conv2a, h), "pool")
        h = block(det.conv3b, block(det.conv3a, h), "pool")
        h = block(det.conv4b, block(det.conv4a, h))
        loc = det.convPb(block(det.convPa, h)).float().permute(0, 2, 3, 1)
        ids = det.convDb(block(det.convDa, h)).float().permute(0, 2, 3, 1)
    assert torch.equal(got["loc"], loc) and torch.equal(got["ids"], ids)
    c = torch.randn(2, 64, 7, 9).to(dtype)
    bn = det.conv1b.bn
    b = det.conv1b.conv.bias
    want = F.batch_norm(c + b.view(1, -1, 1, 1), bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps).clamp_min(0)
    want = F.max_pool2d(want, 2, 2)
    got = conv_epilogue.epilogue_plain(c, b, bn.running_mean, bn.running_var, bn.weight,
                                       bn.bias, bn.eps, "pool")
    assert torch.equal(got, want)


# ----- the card, at the published widths ---------------------------------------
@pytest.mark.cuda
def test_published_widths_on_the_card_against_the_reference():
    """One pair at 480×640, 2048 keypoints, 9 layers, d 256, 4 heads, bf16
    on the card, against the float32 reference on the port's keypoints:
    most keypoints where the reference has them, the match decisions that
    the reference makes clear mostly the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    conf = json.loads((ROOT / "portbench/configs/splg_480x640.json").read_text())
    pipe, sp, lg = pipeline(conf, torch.bfloat16, dev)
    frames = pair_frames(1, tuple(conf["input_hw"]))
    out = pipe.match(frames)
    assert (out[1] > 0).sum(1).tolist() == [2048, 2048]
    sp = {k: v.to(dev) for k, v in sp.items()}
    lg = {k: v.to(dev) for k, v in lg.items()}
    ex = R.extract(sp, torch.from_numpy(frames).to(dev).float()[:, None] / 255.0, conf)
    for i in range(2):
        got = as_set(out[0][i])
        assert len(got & as_set(ex["keypoints"][i].cpu())) >= 0.9 * len(got)
    ka, kb = (torch.from_numpy(out[0][i]).to(dev) for i in (0, 1))
    da = R.sample_descriptors(ka[None], ex["dense_descriptors"][0:1])[0].t()
    db = R.sample_descriptors(kb[None], ex["dense_descriptors"][1:2])[0].t()
    ref = R.match(lg, ka, kb, da, db, tuple(conf["input_hw"][::-1]), conf)
    want, got = ref["matches0"].cpu().numpy(), out[2][0]
    both = (want >= 0) | (got >= 0)
    assert both.any() and (want == got)[both].mean() >= 0.8
