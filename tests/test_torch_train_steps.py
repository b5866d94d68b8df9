"""The port's training steps (``deepcharuco_tpu_torch.train.steps``) against
the JAX package's, on the CPU, at the real layer widths on small frames.

Tolerances: losses within 1e-5 relative; gradients within 5e-5 of each
tensor's largest |gradient| for the detector on its shipped weights, 2e-3
for RefineNet from a seeded init; parameters after three Adam steps within
5e-5 (1% of the detector's learning rate) on at least 99.9% of each
tensor's elements and within 3·lr on all: Adam's g/(|g|+ε) turns the
rounding of a gradient that is nearly zero into a step of a sizeable share
of the learning rate. That is the rule for every element of the biases of
convolutions that feed a BatchNorm and of the running means that absorb
them, whose gradient is zero up to rounding (the batch mean removes them).
Running statistics within 1e-5 of each layer's largest value after one
step, the variances within 1e-4 of it after three.

Gradients and parameters are held against the JAX package run in float64
(``jax.enable_x64``). In training mode BatchNorm's variance is
``E[x²] − E[x]²``, which cancels: JAX's own float32 gradients are off by up
to 1e-2 of their scale on the detector and 4e-2 on RefineNet, the port's by
3e-6 and 1.3e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from deepcharuco_tpu.models import Detector as JDetector
from deepcharuco_tpu.models import RefineNet as JRefineNet
from deepcharuco_tpu.train import steps as JS
from deepcharuco_tpu_torch import weights as W
from deepcharuco_tpu_torch.models import Detector, RefineNet
from deepcharuco_tpu_torch.train import (create_detector_state, create_refinenet_state,
                                         detector_loss_fn, flax_init_,
                                         make_detector_eval_step, make_detector_train_step,
                                         make_refinenet_eval_step, make_refinenet_train_step,
                                         refinenet_loss_fn, state_variables)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_frames.npz")


def det_batch(n=2, hw=(32, 48), seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(scale=0.3, size=(n, *hw, 1)).astype(np.float32)
    hc, wc = hw[0] // 8, hw[1] // 8
    loc = rng.integers(0, 64, size=(n, hc, wc)).astype(np.int32)
    ids = np.full((n, hc, wc), 16, np.int32)
    for b in range(n):                     # a few corner cells, the rest background
        cells = rng.choice(hc * wc, size=5, replace=False)
        ids[b].reshape(-1)[cells] = rng.choice(16, size=5, replace=False)
    loc[ids == 16] = 64
    return images, loc, ids


def rn_batch(n=4, ps=24, seed=0):
    from deepcharuco_tpu_torch.data.device_synth import _heatmaps

    rng = np.random.default_rng(seed)
    patches = rng.normal(scale=0.3, size=(n, ps, ps, 1)).astype(np.float32)
    hp = torch.from_numpy(rng.uniform(8, 56, size=(n, 2)).astype(np.float32))
    return patches, _heatmaps(hp, True)[..., None].numpy()


def port_detector(variables):
    return W.load_state(Detector(16, torch.float32), W.detector_state_dict(variables))


def port_refinenet(variables, **kw):
    return W.load_state(RefineNet(torch.float32, **kw), W.refinenet_state_dict(variables))


def rel(a, b):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def grad_scale(grads, key):
    """The largest |gradient| of the tensor; for the bias of a convolution
    that feeds a BatchNorm (whose gradient is 0 up to rounding), that of
    the convolution's weight."""
    scale = float(np.abs(grads[key]).max())
    if key.endswith("conv.bias"):
        scale = max(scale, float(np.abs(grads[key[:-4] + "weight"]).max()))
    return scale


def grads_as_state_dict(jax_grads, variables, to_sd):
    g = to_sd({"params": jax.tree.map(np.asarray, jax_grads),
               "batch_stats": variables["batch_stats"]})
    return {k: v for k, v in g.items() if "running" not in k and "num_batches" not in k}


CONF_CASES = {"ce": {}, "conf": dict(conf_weight=0.5),
              "conf_topk": dict(conf_weight=0.5, conf_margin=2.0, conf_topk=3),
              "conf_fg_topk": dict(conf_weight=0.3, conf_topk=2, conf_fg_topk=2)}


def as64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("case", sorted(CONF_CASES))
def test_detector_loss_and_gradients_match_jax(case):
    kw = CONF_CASES[case]
    v = W.variables_from_npz(DET)
    images, loc, ids = det_batch()
    with jax.enable_x64(True):
        jdet = JDetector(n_ids=16, dtype=jnp.float64, param_dtype=jnp.float64)
        v64 = as64(v)

        def jloss(params):
            return JS.detector_loss_fn(jdet, params, v64["batch_stats"],
                                       jnp.asarray(images, jnp.float64), jnp.asarray(loc),
                                       jnp.asarray(ids), **kw)

        (jl, (jaux, jstats, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(v64["params"])
        jaux, jgrads, jstats = jax.tree.map(np.asarray, (jaux, jgrads, jstats))
    det = port_detector(v)
    loss, aux, _ = detector_loss_fn(det, torch.from_numpy(images), torch.from_numpy(loc),
                                    torch.from_numpy(ids), **kw)
    loss.backward()
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        assert rel(aux[k], jaux[k]) < 1e-5, (k, float(aux[k]), float(jaux[k]))
    want = grads_as_state_dict(jgrads, v, W.detector_state_dict)
    got = {k: p.grad for k, p in det.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        scale = grad_scale(want, k)
        np.testing.assert_allclose(g.numpy(), want[k], rtol=0, atol=5e-5 * scale + 1e-9,
                                   err_msg=k)
    stats = W.detector_variables(det.state_dict())["batch_stats"]
    for layer, st in jstats.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[layer]["bn"][k], st["bn"][k], rtol=0,
                                       atol=1e-5 * np.abs(st["bn"][k]).max(),
                                       err_msg=f"{layer}/{k}")


REFINE_CASES = {"mse": ({}, {}), "coord": ({}, dict(coord_weight=0.2)),
                "offset": (dict(offset_head=True), dict(offset_weight=0.5, coord_weight=0.1)),
                "p32_bilinear": (dict(patch_size=32, upsample="bilinear"), {})}


@pytest.mark.parametrize("case", sorted(REFINE_CASES))
def test_refinenet_loss_and_gradients_match_jax(case):
    mkw, lkw = REFINE_CASES[case]
    ps = mkw.get("patch_size", 24)
    jrn = JRefineNet(dtype=jnp.float32, **mkw)
    v = jrn.init(jax.random.PRNGKey(3), jnp.zeros((1, ps, ps, 1), jnp.float32))
    v = jax.tree.map(np.asarray, {"params": v["params"], "batch_stats": v["batch_stats"]})
    patches, heat = rn_batch(ps=ps)
    with jax.enable_x64(True):
        jrn64 = JRefineNet(dtype=jnp.float64, param_dtype=jnp.float64, **mkw)
        v64 = as64(v)

        def jloss(params):
            return JS.refinenet_loss_fn(jrn64, params, v64["batch_stats"],
                                        jnp.asarray(patches, jnp.float64),
                                        jnp.asarray(heat, jnp.float64), **lkw)

        (jl, (jaux, _, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(v64["params"])
        jaux, jgrads = jax.tree.map(np.asarray, (jaux, jgrads))
    rn = port_refinenet(v, **mkw)
    loss, aux, _ = refinenet_loss_fn(rn, torch.from_numpy(patches), torch.from_numpy(heat), **lkw)
    loss.backward()
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        assert rel(aux[k], jaux[k]) < 1e-5, (k, float(aux[k]), float(jaux[k]))
    want = grads_as_state_dict(jgrads, v, W.refinenet_state_dict)
    for k, p in rn.named_parameters():
        scale = grad_scale(want, k)
        np.testing.assert_allclose(p.grad.numpy(), want[k], rtol=0, atol=2e-3 * scale + 1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["detector", "refinenet"])
def test_three_adam_steps_match_optax(kind):
    f64 = dict(dtype=jnp.float64, param_dtype=jnp.float64)
    if kind == "detector":
        v, lr = W.variables_from_npz(DET), 5e-3
        jmodel = JDetector(n_ids=16, **f64)
        batch = det_batch(n=2)
        model = port_detector(v)
        state = create_detector_state(model, lr)
        step = make_detector_train_step(conf_weight=0.5, conf_topk=2)
        jstep = JS.make_detector_train_step(jmodel, optax.adam(lr), conf_weight=0.5, conf_topk=2)
        to_sd, to_vars = W.detector_state_dict, W.detector_variables
    else:
        v, lr = W.variables_from_npz(RN), 1e-4
        jmodel = JRefineNet(**f64)
        batch = rn_batch()
        model = port_refinenet(v)
        state = create_refinenet_state(model, lr)
        step = make_refinenet_train_step()
        jstep = JS.make_refinenet_train_step(jmodel, optax.adam(lr))
        to_sd, to_vars = W.refinenet_state_dict, W.refinenet_variables
    tb = [torch.from_numpy(a) for a in batch]
    jlosses = []
    with jax.enable_x64(True):
        v64 = as64(v)
        jstate = JS.TrainState(step=jnp.zeros((), jnp.int32), params=v64["params"],
                               batch_stats=v64["batch_stats"],
                               opt_state=optax.adam(lr).init(v64["params"]))
        jstep = jax.jit(jstep)
        jb = [jnp.asarray(a, jnp.float64) if a.dtype == np.float32 else jnp.asarray(a)
              for a in batch]
        for _ in range(3):
            jstate, jaux = jstep(jstate, *jb)
            jlosses.append(float(jaux["loss"]))
        assert int(jstate.step) == 3
        want = to_sd(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    for i in range(3):
        state, aux = step(state, *tb)
        assert rel(aux["loss"], jlosses[i]) < 1e-5, (i, float(aux["loss"]), jlosses[i])
    assert state.step == 3
    for k, t in model.state_dict().items():
        if "num_batches" in k:
            continue
        diff = np.abs(t.numpy() - want[k])
        if k.endswith("running_var"):
            assert diff.max() <= 1e-4 * np.abs(want[k]).max(), (k, diff.max())
            continue
        assert diff.max() <= 3 * lr, (k, diff.max())
        if not k.endswith(("conv.bias", "running_mean")):
            close = diff <= 5e-5 + 1e-5 * np.abs(want[k])
            assert close.mean() >= 0.999, (k, close.mean(), diff.max())
    assert sorted(W.flatten_variables(state_variables(state))) == \
        sorted(W.flatten_variables(to_vars(to_sd(v))))


def test_fixture_refinenet_steps_match_the_stored_jax_losses():
    """The RefineNet half of ``chip_smoke.py`` phase 13 on the CPU: three
    Adam steps from the shipped weights on the stored batch, the losses
    within the card check's 1e-4 relative. The stored values are JAX's
    float32 ones, whose own rounding in training-mode BatchNorm is of order
    1e-5 here; the tests above hold the port to JAX in float64 at 1e-5."""
    with np.load(FIXTURE) as z:
        fix = {k: z[k] for k in z.files if k.startswith(("train/rn/", "synth/refine/out/"))}
    model = port_refinenet(W.variables_from_npz(RN))
    state = create_refinenet_state(model, 1e-4)
    step = make_refinenet_train_step()
    batch = [torch.from_numpy(fix[f"synth/refine/out/{k}"]) for k in ("patches", "heatmaps")]
    for i in range(3):
        state, aux = step(state, *batch)
        assert rel(aux["loss"], fix["train/rn/loss"][i]) < 1e-4, i
    stats = W.flatten_variables({"batch_stats": state_variables(state)["batch_stats"]})
    for k, value in stats.items():
        want = fix[f"train/rn/{k}"]
        np.testing.assert_allclose(value, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_running_statistics_use_the_biased_variance():
    """Two 16×16 frames leave a 2×2 grid at conv4: BatchNorm there sees 8
    values per channel, and torch's own running update would store 8/7 of
    the biased variance. The port stores Flax's: momentum 0.9, biased."""
    v = W.variables_from_npz(DET)
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 1)).astype(np.float32)
    _, mutated = JDetector(n_ids=16, dtype=jnp.float32).apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    det = port_detector(v)
    acts = {}
    det.conv4b.conv.register_forward_hook(lambda m, i, o: acts.setdefault("x", o.detach()))
    det(torch.from_numpy(x), train=True)
    got = W.detector_variables(det.state_dict())["batch_stats"]
    for layer in ("conv1a", "conv3b", "conv4b", "convPa"):
        for k in ("mean", "var"):
            want = np.asarray(mutated["batch_stats"][layer]["bn"][k])
            np.testing.assert_allclose(got[layer]["bn"][k], want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{layer}/{k}")
    xb = acts["x"]                                        # (2, 128, 2, 2)
    assert xb.shape[2:] == (2, 2)
    biased = xb.var(dim=(0, 2, 3), unbiased=False)
    start = torch.from_numpy(np.array(v["batch_stats"]["conv4b"]["bn"]["var"]))
    np.testing.assert_allclose(got["conv4b"]["bn"]["var"], (0.9 * start + 0.1 * biased).numpy(),
                               rtol=1e-4)
    rv, rm = start.clone(), torch.zeros(128)
    F.batch_norm(xb, rm, rv, training=True, momentum=0.1)
    torch_incr = rv - 0.9 * start                            # 0.1 × the unbiased variance
    np.testing.assert_allclose(torch_incr.numpy(), (0.1 * biased * 8 / 7).numpy(), rtol=1e-4)
    assert not np.allclose(got["conv4b"]["bn"]["var"], rv.numpy(), rtol=1e-3)


def test_eval_steps_use_running_statistics_without_gradients():
    v = W.variables_from_npz(DET)
    images, loc, ids = (torch.from_numpy(a) for a in det_batch())
    det = port_detector(v)
    state = create_detector_state(det)
    before = {k: t.clone() for k, t in det.state_dict().items()}
    aux, out = make_detector_eval_step()(state, images, loc, ids)
    assert not out["loc"].requires_grad and state.step == 0
    assert all(torch.equal(before[k], t) for k, t in det.state_dict().items())
    jl, _ = JS.detector_loss_fn(JDetector(n_ids=16, dtype=jnp.float32), v["params"],
                                v["batch_stats"], jnp.asarray(images.numpy()),
                                jnp.asarray(loc.numpy()), jnp.asarray(ids.numpy()), train=False)
    assert rel(aux["loss"], jl) < 1e-5
    rn = port_refinenet(W.variables_from_npz(RN))
    patches, heat = (torch.from_numpy(a) for a in rn_batch())
    aux, h = make_refinenet_eval_step()(create_refinenet_state(rn), patches, heat)
    assert h.shape == (4, 64, 64, 1) and not h.requires_grad
    assert rel(aux["loss"], ((h - heat) ** 2).mean()) < 1e-6


def test_flax_init_matches_flax_default_statistics():
    det = flax_init_(Detector(16, torch.float32), seed=0)
    jv = JDetector(n_ids=16, dtype=jnp.float32).init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 16, 16, 1)))
    for name in ("conv1b", "conv4a", "convPa"):
        w = getattr(det, name).conv.weight
        jw = np.asarray(jv["params"][name]["conv"]["kernel"])
        assert abs(float(w.detach().std()) / float(jw.std()) - 1) < 0.05, name
        assert float(w.detach().abs().max()) <= 2 / np.sqrt(w[0].numel()) / 0.8796 + 1e-6
        assert not getattr(det, name).conv.bias.any()
        assert torch.equal(getattr(det, name).bn.weight, torch.ones_like(getattr(det, name).bn.weight))
    assert abs(float(det.convPb.weight.detach().std()) * np.sqrt(256) - 1) < 0.05
    a = flax_init_(Detector(16, torch.float32), seed=3).state_dict()
    b = flax_init_(Detector(16, torch.float32), seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
