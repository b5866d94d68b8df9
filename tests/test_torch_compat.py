"""The port's checkpoint forms against the JAX package's: the Lightning
converter (``compat``) bit-equal with ``deepcharuco_tpu.compat`` on the
shipped and on seeded weights, ``.ckpt`` files that either package writes
loading in the other, and ``load_model_variables``/``load_pipeline`` on the
three checkpoint cases of ``tests/test_load_pipeline.py`` side by side with
the JAX package (fault C1: the port refused everything but ``.npz``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcharuco_tpu import compat as jcompat
from deepcharuco_tpu import pipeline as jpipe
from deepcharuco_tpu.configs import default_config
from deepcharuco_tpu.models import Detector as JDetector, RefineNet as JRefineNet
from deepcharuco_tpu_torch import compat, pipeline
from deepcharuco_tpu_torch.train.checkpoints import CheckpointManager
from deepcharuco_tpu_torch.weights import flatten_variables, variables_from_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET = os.path.join(ROOT, "artifacts", "detector_devsynth.npz")
RN = os.path.join(ROOT, "artifacts", "refinenet_devsynth.npz")
CFG = default_config()


def host(tree):
    return jax.tree.map(np.asarray, tree)


def seeded(kind, seed):
    if kind == "detector":
        return host(JDetector(n_ids=16, dtype=jnp.float32).init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 48, 48, 1))))
    return host(JRefineNet(dtype=jnp.float32).init(jax.random.PRNGKey(seed),
                                                   jnp.zeros((1, 24, 24, 1))))


def shipped(kind):
    return variables_from_npz(DET if kind == "detector" else RN)


def assert_trees_equal(a, b):
    fa, fb = flatten_variables(a), flatten_variables(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def write_lightning_ckpt(path, sd):
    """As ``tests/test_load_pipeline.py`` writes one: a bare torch pickle."""
    torch.save({"state_dict": {f"model.{k}": torch.from_numpy(np.asarray(v).copy())
                               for k, v in sd.items()}, "epoch": 99}, path)


@pytest.mark.parametrize("kind", ["detector", "refinenet"])
@pytest.mark.parametrize("source", ["shipped", "seeded"])
def test_state_dicts_bit_equal_with_the_jax_converter(kind, source):
    v = shipped(kind) if source == "shipped" else seeded(kind, 3)
    if kind == "refinenet":     # the reference's RefineNet has no 32-px layers
        v = {c: {k: x for k, x in t.items() if k not in ("conv2c", "conv2d")}
             for c, t in v.items()}
    to_sd = {"detector": (compat.detector_state_dict_from_variables,
                          jcompat.detector_state_dict_from_variables),
             "refinenet": (compat.refinenet_state_dict_from_variables,
                           jcompat.refinenet_state_dict_from_variables)}[kind]
    ours, theirs = to_sd[0](v), to_sd[1](v)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    from_sd = {"detector": (compat.detector_variables_from_torch,
                            jcompat.detector_variables_from_torch),
               "refinenet": (compat.refinenet_variables_from_torch,
                             jcompat.refinenet_variables_from_torch)}[kind]
    prefixed = {f"model.{k}": torch.from_numpy(np.array(x)) for k, x in ours.items()}
    assert_trees_equal(from_sd[0](prefixed), host(from_sd[1](prefixed)))
    assert_trees_equal(from_sd[0](prefixed), v)


@pytest.mark.parametrize("kind", ["detector", "refinenet"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ckpt_from_either_package_loads_in_the_other(tmp_path, kind, writer):
    v = seeded(kind, 11)
    path = str(tmp_path / f"{kind}.ckpt")
    (compat if writer == "port" else jcompat).save_lightning_checkpoint(path, v, kind)
    ours = pipeline.load_model_variables(path, kind)
    theirs = host(jpipe.load_model_variables(path, kind))
    assert_trees_equal(ours, theirs)
    assert_trees_equal(ours, v)


def jax_detect(dv, rv, frames):
    out = jax.jit(lambda dv, rv, x: jpipe.two_stage_forward(
        JDetector(n_ids=16, dtype=jnp.float32),
        JRefineNet(dtype=jnp.float32) if rv is not None else None, dv, rv, x, 16))(
            dv, rv, jnp.asarray(frames))
    return tuple(np.asarray(o) for o in out)


def assert_detect_agrees(port_out, jax_out):
    kp, valid, refined = port_out
    np.testing.assert_array_equal(valid, jax_out[1])
    np.testing.assert_array_equal(kp[valid], jax_out[0][valid])
    np.testing.assert_allclose(refined[valid], jax_out[2][valid], atol=2e-3)


def test_c1_lightning_ckpts_serve_in_both_packages(tmp_path):
    dv, rv = seeded("detector", 0), seeded("refinenet", 1)
    d_path, r_path = str(tmp_path / "deepc.ckpt"), str(tmp_path / "refinenet.ckpt")
    write_lightning_ckpt(d_path, jcompat.detector_state_dict_from_variables(dv))
    write_lightning_ckpt(r_path, jcompat.refinenet_state_dict_from_variables(rv))
    frames = np.random.default_rng(0).integers(0, 255, (1, 240, 320, 3)).astype(np.uint8)
    port = pipeline.load_pipeline(CFG, d_path, r_path, compute_dtype=torch.float32,
                                  device="cpu").detect(frames)
    theirs = jpipe.load_pipeline(CFG, d_path, r_path, compute_dtype=jnp.float32).detect(frames)
    assert_detect_agrees(port, tuple(np.asarray(t) for t in theirs))
    assert_detect_agrees(port, jax_detect(dv, rv, frames))


def test_c1_trainer_directory_serves(tmp_path):
    """The directory the port's trainers write (and print as the best
    checkpoint) serves like its ``variables.npz``; the JAX package reads that
    file as it is."""
    dv = seeded("detector", 2)
    mgr = CheckpointManager(str(tmp_path / "ck"), top_k=2)
    path = mgr.save("step_0000042", dv, metric=0.5)
    frames = np.zeros((1, 240, 320, 3), np.uint8)
    port = pipeline.load_pipeline(CFG, path, RN, compute_dtype=torch.float32,
                                  device="cpu").detect(frames)
    via_npz = pipeline.load_pipeline(CFG, os.path.join(path, "variables.npz"), RN,
                                     compute_dtype=torch.float32, device="cpu").detect(frames)
    for a, b in zip(port, via_npz):
        np.testing.assert_array_equal(a, b)
    assert_trees_equal(pipeline.load_model_variables(path + "/", "detector"), dv)
    theirs = jpipe.load_pipeline(CFG, os.path.join(path, "variables.npz"), RN,
                                 compute_dtype=jnp.float32).detect(frames)
    assert_detect_agrees(port, tuple(np.asarray(t) for t in theirs))


def test_c1_exported_ckpt_roundtrips_through_both_packages(tmp_path):
    dv = seeded("detector", 7)
    path = str(tmp_path / "export.ckpt")
    compat.save_lightning_checkpoint(path, dv, "detector")
    frames = np.random.default_rng(1).integers(0, 255, (1, 240, 320, 3)).astype(np.uint8)
    port = pipeline.load_pipeline(CFG, path, compute_dtype=torch.float32,
                                  device="cpu").detect(frames)
    theirs = jpipe.load_pipeline(CFG, path, compute_dtype=jnp.float32).detect(frames)
    assert_detect_agrees(port, tuple(np.asarray(t) for t in theirs))
    assert_detect_agrees(port, jax_detect(dv, None, frames))


def test_an_orbax_directory_is_refused_with_the_route(tmp_path):
    d = tmp_path / "step_0000001"
    d.mkdir()
    (d / "checkpoint").write_text("{}")
    with pytest.raises(ValueError, match="JAX's format.*load_model_variables.*variables_to_npz"):
        pipeline.load_pipeline(CFG, str(d), device="cpu")
    with pytest.raises(ValueError, match="not a .ckpt or .npz"):
        pipeline.load_model_variables(str(tmp_path / "missing"), "detector")


def test_seeded_weights_and_the_kind_check():
    a = pipeline.load_model_variables(None, "detector")
    b = pipeline.load_model_variables(None, "detector")
    assert_trees_equal(a, b)
    assert "conv5b" in pipeline.load_model_variables(None, "refinenet")["params"]
    with pytest.raises(ValueError, match="kind"):
        pipeline.load_model_variables(None, "trunk")
