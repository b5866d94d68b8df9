"""The port's int8 detector (``deepcharuco_tpu_torch.models.quant``) against
the JAX package's, on the CPU.

The same ``qvars`` and the same numpy frames go through both
``QuantDetector``s. Tolerances: every layer's int32 accumulator equal (so
every int8 activation is), logits ``rtol 1e-4, atol 1e-3``, the decode
identical. ``quantize_detector`` on the same weights and calibration
frames: int8 kernels equal, scales and biases ``rtol 1e-5`` (the
calibration maxima come from two float32 convolutions that sum in
different orders)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.models import quant as jquant
from deepcharuco_tpu.ops import pred_to_keypoints as jpred_to_keypoints
from deepcharuco_tpu.pipeline import is_quantized_npz as jis_quantized_npz
from deepcharuco_tpu_torch.configs import default_config
from deepcharuco_tpu_torch.models import Detector
from deepcharuco_tpu_torch.models import quant as tquant
from deepcharuco_tpu_torch.models.quant import QuantDetector
from deepcharuco_tpu_torch.ops import pred_to_keypoints
from deepcharuco_tpu_torch.pipeline import (InferencePipeline, is_quantized_npz,
                                            load_detector_any, load_pipeline,
                                            two_stage_forward)
from deepcharuco_tpu_torch.weights import (detector_state_dict, load_state,
                                           variables_from_npz)

CFG = default_config()
FIXTURE = "tests/data/torch_port_frames.npz"
DET = "artifacts/detector_devsynth.npz"
RN = "artifacts/refinenet_devsynth.npz"
RN32 = "artifacts/refinenet32_devsynth.npz"
INT8 = "artifacts/detector_devsynth_int8.npz"


@pytest.fixture(scope="module")
def fix():
    return dict(np.load(FIXTURE))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _normalized(frames_u8):
    return ((frames_u8.astype(np.float32) - 128.0) / 255.0)[..., None]


@pytest.fixture(scope="module")
def random_setup():
    """A seeded Flax detector, calibration frames, and JAX's quantization."""
    det = JDetector(n_ids=CFG.n_ids, dtype=jnp.float32)
    dv = det.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    rng = np.random.default_rng(0)
    g = _normalized(rng.integers(0, 256, (2, 64, 64)).astype(np.uint8))
    qv = jquant.quantize_detector(det, dv, jnp.asarray(g))
    return _np_tree(dict(dv)), g, _np_tree(qv)


def jax_forward(qv, g):
    """The JAX ``QuantDetector.apply`` step by step with the module's own
    functions, keeping every int32 accumulator; checked against ``apply``."""
    qv = jax.tree.map(jnp.asarray, qv)
    accs = []
    q = jnp.clip(jnp.round(jnp.asarray(g) * 255.0), -128, 127).astype(jnp.int8)
    pad = 0
    for name, pool in jquant._ENCODER:
        accs.append(np.asarray(jquant._qconv(q, qv[name], pad)))
        q = jquant._block(q, qv[name], pad)
        pad = jquant._ZP
        if pool:
            q = jquant._pool(q)
    heads = {}
    for out, a, b in (("loc", "convPa", "convPb"), ("ids", "convDa", "convDb")):
        accs.append(np.asarray(jquant._qconv(q, qv[a], jquant._ZP)))
        h = jquant._block(q, qv[a], jquant._ZP)
        acc = jquant._qconv(h, qv[b], None)
        accs.append(np.asarray(acc))
        heads[out] = np.asarray(acc.astype(jnp.float32) * qv[b]["scale"] + qv[b]["bias"])
    ref = jquant.QuantDetector(CFG.n_ids).apply(qv, jnp.asarray(g))
    for k in heads:
        np.testing.assert_array_equal(heads[k], np.asarray(ref[k]))
    return heads, accs


def _assert_same_forward(qv, g):
    heads_r, accs_r = jax_forward(qv, g)
    accs = []
    with torch.inference_mode():
        heads = QuantDetector(qv, CFG.n_ids).eval()(torch.from_numpy(g), accumulators=accs)
    assert len(accs) == len(accs_r) == 12
    for i, (a, b) in enumerate(zip(accs, accs_r)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"accumulator {i}")
    for k in ("loc", "ids"):
        assert heads[k].dtype == torch.float32
        np.testing.assert_allclose(heads[k].numpy(), heads_r[k], rtol=1e-4, atol=1e-3)
    kp_r, v_r = (np.asarray(o) for o in jpred_to_keypoints(
        jnp.asarray(heads_r["loc"]), jnp.asarray(heads_r["ids"]), CFG.n_ids))
    kp, v = (t.numpy() for t in pred_to_keypoints(heads["loc"], heads["ids"], CFG.n_ids))
    np.testing.assert_array_equal(v, v_r)
    np.testing.assert_array_equal(kp[v_r], kp_r[v_r])
    return heads, v_r


def test_quant_detector_matches_jax_on_the_same_qvars(random_setup):
    _, g, qv = random_setup
    heads, _ = _assert_same_forward(qv, g)
    assert heads["loc"].shape == (2, 8, 8, 65) and heads["ids"].shape == (2, 8, 8, 17)


def test_shipped_int8_artifact_matches_jax_at_small_frames(fix):
    """The shipped artifact as it is (HWIO int8 kernels → OIHW) on crops of
    the fixture frames: odd sizes too, where the pools floor."""
    qv = tquant.qvars_from_npz(INT8)
    assert qv["conv1a"]["w"].dtype == np.int8 and qv["conv1a"]["w"].shape == (3, 3, 1, 64)
    _, v = _assert_same_forward(qv, _normalized(fix["frames"][:2, 60:180, 80:240]))
    assert v.sum() >= 4
    _assert_same_forward(qv, _normalized(fix["frames"][:1, 40:99, 90:163]))


def test_fractional_grays_quantize_as_in_jax(random_setup):
    """Under the hi-res tap the detector sees a pooled view: grays with
    fractions, which the input quantizer rounds half to even in both."""
    _, g, qv = random_setup
    pooled = g.reshape(2, 32, 2, 32, 2, 1).mean(axis=(2, 4))
    assert (np.abs(pooled * 255 - np.round(pooled * 255)) > 0.2).any()
    _assert_same_forward(qv, pooled.astype(np.float32))


def test_quantize_detector_matches_jax(random_setup):
    dv, g, qv_ref = random_setup
    det = load_state(Detector(CFG.n_ids, torch.float32), detector_state_dict(dv)).eval()
    qv = tquant.quantize_detector(det, dv, g, device="cpu")
    assert sorted(qv) == sorted(qv_ref)
    for name, layer in qv_ref.items():
        assert sorted(qv[name]) == sorted(layer), name
        assert qv[name]["w"].dtype == np.int8
        np.testing.assert_array_equal(qv[name]["w"], layer["w"], err_msg=name)
        for k in layer:
            if k != "w":
                assert qv[name][k].dtype == np.float32, (name, k)
                np.testing.assert_allclose(qv[name][k], layer[k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"{name}/{k}")
    # the pieces, on one block
    p, s = dv["params"]["conv2a"], dv["batch_stats"]["conv2a"]
    k_ref, b_ref = jquant.fold_bn(p, s)
    k, b = tquant.fold_bn(p, s)
    np.testing.assert_allclose(k, np.asarray(k_ref), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(b, np.asarray(b_ref), rtol=1e-6, atol=1e-9)
    w_ref, sw_ref = jquant.quantize_weight(k_ref)
    w, sw = tquant.quantize_weight(np.asarray(k_ref))
    np.testing.assert_array_equal(w, np.asarray(w_ref))
    np.testing.assert_array_equal(sw, np.asarray(sw_ref))
    act_ref = jquant.calibrate_activations(JDetector(n_ids=16, dtype=jnp.float32),
                                           jax.tree.map(jnp.asarray, dv), jnp.asarray(g))
    act = tquant.calibrate_activations(det, torch.from_numpy(g))
    assert sorted(act) == sorted(act_ref) and len(act) == 10
    for name in act:
        assert act[name] == pytest.approx(act_ref[name], rel=1e-5)
    assert not det.conv1a._forward_hooks        # the hooks are gone again


def test_quantized_logits_track_the_float_detector(random_setup):
    dv, g, qv = random_setup
    det = load_state(Detector(CFG.n_ids, torch.float32), detector_state_dict(dv)).eval()
    with torch.inference_mode():
        out_f = det(torch.from_numpy(g))
        out_q = QuantDetector(qv, CFG.n_ids)(torch.from_numpy(g))
    for head in ("loc", "ids"):
        a, b = out_f[head].numpy().ravel(), out_q[head].numpy().ravel()
        assert np.corrcoef(a, b)[0, 1] > 0.999
        assert np.abs(a - b).max() / (np.abs(a).max() + 1e-9) < 0.05


def test_qvars_npz_round_trip_and_auto_detection(tmp_path, random_setup, fix):
    _, _, qv = random_setup
    path = str(tmp_path / "det_int8.npz")
    tquant.qvars_to_npz(path, qv)
    assert is_quantized_npz(path) and jis_quantized_npz(path)
    back, back_jax = tquant.qvars_from_npz(path), _np_tree(jquant.qvars_from_npz(path))
    for name, layer in qv.items():
        for k, v in layer.items():
            assert back[name][k].dtype == v.dtype
            np.testing.assert_array_equal(back[name][k], v)
            np.testing.assert_array_equal(back_jax[name][k], v)
    # a file that the JAX package wrote reads the same
    jpath = str(tmp_path / "det_int8_jax.npz")
    jquant.qvars_to_npz(jpath, qv)
    np.testing.assert_array_equal(tquant.qvars_from_npz(jpath)["convPb"]["w"],
                                  qv["convPb"]["w"])
    # load_pipeline routes by the layout, no flag
    pipe = load_pipeline(CFG, path, device="cpu")
    assert isinstance(pipe.detector, QuantDetector) and not pipe.detector.training
    x = fix["frames"][:1, :64, :64]
    kp, valid, _ = pipe.detect(x)
    with torch.inference_mode():
        out = QuantDetector(back, CFG.n_ids)(torch.from_numpy(_normalized(x)))
        kp_d, v_d = pred_to_keypoints(out["loc"], out["ids"], CFG.n_ids)
    np.testing.assert_array_equal(valid, v_d.numpy())
    np.testing.assert_array_equal(kp, kp_d.numpy())
    assert isinstance(load_detector_any(path, 16, device="cpu"), QuantDetector)
    float_det = load_detector_any(DET, 16, torch.float32, device="cpu")
    assert isinstance(float_det, Detector) and not float_det.training
    want = detector_state_dict(variables_from_npz(DET))["conv3a.conv.weight"]
    np.testing.assert_array_equal(float_det.conv3a.conv.weight.detach().numpy(), want)
    assert isinstance(load_detector_any(None, 16, device="cpu"), Detector)


def test_shipped_int8_pipeline_agrees_with_stored_jax_outputs(fix):
    """``load_pipeline`` on the shipped artifact with the bf16 RefineNet,
    two frames, against the JAX int8 pipeline's stored outputs: the integer
    detector decodes identically; ``refined`` within 0.125 px (one heatmap
    bin) on ≥ 98% of the slots, the limits of the bf16 path."""
    pipe = load_pipeline(CFG, INT8, RN, device="cpu")
    kp, valid, refined = pipe.detect(fix["frames"][:2])
    kr, vr, rr = (fix[f"{k}_int8"][:2] for k in ("keypoints", "valid", "refined"))
    np.testing.assert_array_equal(valid, vr)
    np.testing.assert_array_equal(kp[vr], kr[vr])
    assert vr.sum() >= 20
    assert (np.abs(refined - rr).max(-1)[vr] <= 0.125).mean() >= 0.98


def test_int8_composes_with_the_hires_tap(fix):
    """The production-shaped composition (hi-res tap, 32-px RefineNet, avg
    decode) serves the int8 artifact too; against the float detector the
    pooled view's ±0.5 gray level flips a few 1-px bins and no cell."""
    outs = {}
    for name, ckpt in (("f32", DET), ("int8", INT8)):
        pipe = load_pipeline(CFG, ckpt, RN32, hires=True, rn_patch_size=32, rn_decode="avg",
                             device="cpu")
        outs[name] = pipe.detect(fix["frames_hi"][:1])
    (kp_f, v_f, r_f), (kp_q, v_q, r_q) = outs["f32"], outs["int8"]
    assert v_f.sum() >= 8 and v_q.sum() >= 8
    assert (v_f == v_q).mean() >= 0.9
    both = v_f & v_q
    d_kp = np.linalg.norm(kp_f - kp_q, axis=-1)[both]
    assert (d_kp == 0).mean() >= 0.5 and d_kp.max() <= 1.5
    assert np.linalg.norm(r_f - r_q, axis=-1)[both].max() <= 0.3


SNIFFER_CASES = ["none", "missing", "f32_weights", "corrupt", "f32_conv1a", "legacy", "marked"]


@pytest.mark.parametrize("case", SNIFFER_CASES)
def test_is_quantized_npz_never_misroutes(tmp_path, case):
    """Missing, corrupt and float files give False (the float loader then
    raises its own error); only a real int8 artifact gives True. The same
    answers as the JAX package's sniffer."""
    path = str(tmp_path / f"{case}.npz")
    want = False
    if case == "none":
        path = None
    elif case == "f32_weights":
        path = RN
    elif case == "corrupt":
        with open(path, "wb") as f:
            f.write(b"not a zip at all")
    elif case == "f32_conv1a":
        np.savez(path, **{"conv1a/w": np.zeros((3, 3, 1, 64), np.float32)})
    elif case == "legacy":      # written before the marker: int8 conv1a/w
        np.savez(path, **{"conv1a/w": np.zeros((3, 3, 1, 64), np.int8)})
        want = True
    elif case == "marked":
        np.savez(path, __quant__=np.int8(1))
        want = True
    assert is_quantized_npz(path) is want
    assert jis_quantized_npz(path) is want
    if case == "corrupt":       # the float loader's own error, not the sniffer's
        with pytest.raises(Exception) as err:
            load_pipeline(CFG, path, device="cpu")
        assert not isinstance(err.value, NotImplementedError)


def test_int8_guards(random_setup):
    _, g, qv = random_setup
    with pytest.raises(ValueError, match="unknown det_quant"):
        InferencePipeline(CFG, qv, det_quant="int4", device="cpu")
    with pytest.raises(ValueError, match="fused_head=False"):
        InferencePipeline(CFG, qv, det_quant="int8", fused_head=True, device="cpu")
    with pytest.raises(ValueError, match="fused_head=False"):
        load_pipeline(CFG, INT8, fused_head=True, device="cpu")
    det = QuantDetector(qv, 16).eval()
    with pytest.raises(ValueError, match="fused_head=False"):
        two_stage_forward(det, None, np.zeros((1, 64, 64), np.uint8), 16, fused_head=True,
                          device="cpu")
    with pytest.raises(ValueError, match="no bf16 trunk"):
        det(torch.from_numpy(g), trunk_only=True)
    assert all(b.dtype == torch.int8 for n, b in det.named_buffers() if n.endswith("_w"))
    assert det.conv1b_w.shape == (64, 64, 3, 3) and not list(det.parameters())


@pytest.mark.parametrize("entry", ["load_detector_any", "quantize_detector", "load_pipeline"])
def test_int8_entry_points_raise_without_a_card(monkeypatch, random_setup, entry):
    dv, g, _ = random_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "load_detector_any":
            load_detector_any(INT8, 16)
        elif entry == "load_pipeline":
            load_pipeline(CFG, INT8)
        else:
            tquant.quantize_detector(Detector(16, torch.float32).eval(), dv, g)


def test_chunks_of_frames_give_the_whole_batch(random_setup, monkeypatch):
    """A large batch goes through the net in chunks of frames: one frame per
    chunk gives the logits and the accumulators of the whole batch."""
    _, g, qv = random_setup
    g = np.concatenate([g, g[::-1], g[:1]])
    det = QuantDetector(qv, CFG.n_ids).eval()
    whole_acc, one_acc = [], []
    with torch.inference_mode():
        whole = det(torch.from_numpy(g), accumulators=whole_acc)
        monkeypatch.setattr(tquant, "_CHUNK_PIXELS", 1)
        one = det(torch.from_numpy(g), accumulators=one_acc)
        assert det(torch.from_numpy(g))["loc"].shape == (5, 8, 8, 65)
    for k in whole:
        assert torch.equal(whole[k], one[k])
    assert len(one_acc) == len(whole_acc) == 12
    assert all(a.shape[0] == 5 and torch.equal(a, b) for a, b in zip(whole_acc, one_acc))


def test_padding_inside_is_minus_128(random_setup):
    """``F.conv2d``'s own padding pads with 0, which inside the net is the
    activation 128/255·max, not 0: the accumulators at the border differ."""
    _, _, qv = random_setup
    w = torch.from_numpy(np.ascontiguousarray(qv["conv1b"]["w"].transpose(3, 2, 0, 1)))
    q = torch.full((1, 6, 6, 64), -128, dtype=torch.int8)
    acc = tquant.qconv_acc(q, w, -128)
    assert acc.shape == (1, 6, 6, 64)
    assert (acc == acc[:, 2:3, 2:3]).all()          # a constant image stays constant
    zero_padded = tquant.qconv_acc(q, w, 0)
    assert not torch.equal(zero_padded, acc)
    assert torch.equal(zero_padded[:, 1:-1, 1:-1], acc[:, 1:-1, 1:-1])
    assert os.path.exists(INT8)
